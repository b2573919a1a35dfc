#!/usr/bin/env python3
"""Every resample path once on an NVIDIA GPU, byte-compared with the oracle.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One-card phases, in order: device, reciprocal (exhaustive over the kernel
window sums), goldens (C-reference md5s), headline farm (1024 stereo streams,
48k->44.1k, 4096-frame chunks), every ratio class and API path at its
benchmark shape, and host-clock timing of each class's launch and farm
cycle.
Every output is compared byte for byte with ops.convolve.convolve_frames
(pinned to the C vectors) run on this process's CPU device. A failed check
raises; the last line, one JSON object naming the device, is printed only
when every phase passed. The script refuses to run anywhere but a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

CPU = None       # this process's CPU device: where the oracle runs
TABLE = None     # the default model's LUT (numpy)


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# The oracle: ops.convolve on the CPU device, driven by exact host positions
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_taps",))
def _oracle_jit(table, x, pos, frac, cfg, max_taps):
    from clownresampler_tpu.ops.convolve import convolve_frames

    return convolve_frames(table, x, pos, frac, cfg, max_taps)


def oracle_frames(x, cfg, increment, p0, f0, n):
    """Frames [0, n) of a phase run starting at (p0, f0) over rows ``x``
    (S, L): convolve_frames on the CPU, in pieces that bound its gather."""
    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.ops.convolve import ConfigScalars

    taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    lanes = x.shape[1]
    piece = max(64, min(4096, (256 << 20) // (4 * taps * lanes)) // 64 * 64)
    with jax.default_device(CPU):
        xs = jnp.asarray(x)
        scal = ConfigScalars.from_configuration(cfg, increment)
        table = jnp.asarray(TABLE)
        outs = []
        for lo in range(0, n, piece):
            m = np.arange(lo, lo + piece, dtype=np.int64)
            t = f0 + m * increment
            pos = np.minimum(p0 + (t >> 16), x.shape[0]).astype(np.int32)
            frac = (t & 0xFFFF).astype(np.int32)
            out = _oracle_jit(table, xs, jnp.asarray(pos), jnp.asarray(frac),
                              scal, taps)
            outs.append(np.asarray(out)[: min(piece, n - lo)])
    return np.concatenate(outs) if outs else np.zeros((0, lanes), np.int32)


def oracle_farm(data, schedule, r_bound):
    """What a farm emits for lane-major ``data`` (N, L) int16 fed in chunks.

    ``schedule`` is [(chunk_frames, (in, out, lpf)), ...]: the rates apply
    from that chunk on (a farm adjust between chunks). This replays the
    reference's LowLevel calls the farm stands for: after each chunk, every
    frame visible against all received data minus a radius_bound hold-back;
    flush adds radius_bound zero frames (ResampleEnd).
    """
    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.configure import configure

    lanes = data.shape[1]
    padded = np.concatenate([np.zeros((r_bound, lanes), np.int16), data,
                             np.zeros((r_bound, lanes), np.int16)])
    pi = pf = 0               # LowLevel position, relative to `consumed`
    consumed = received = 0
    out = []
    cfg = inc = None

    def resample(n_visible):
        nonlocal pi, pf, consumed
        r = cfg.integer_stretched_kernel_radius
        start = r_bound + consumed - r
        window = padded[start : start + n_visible + 2 * r]
        num = ((n_visible - pi) << 16) - pf
        n = 0 if num <= 0 else -(-num // inc)
        out.append(oracle_frames(window, cfg, inc, pi, pf, n))
        t = pf + n * inc
        pi, pf = pi + (t >> 16), t & 0xFFFF
        delta = min(pi, n_visible)
        pi -= delta
        consumed += delta

    for size, rates in schedule + [(None, None)]:
        if rates is not None:
            cfg = configure(*rates)
            inc = fx.calculate_ratio(rates[0], rates[1])
        if size is None:       # flush: the hold-back plus r_bound zeros
            resample(received - consumed)
        else:
            received += size
            if received - consumed - r_bound > 0:
                resample(received - consumed - r_bound)
    return np.concatenate(out)


def lanes_of(per_stream):
    """(B, M, C) farm output -> (M, B*C) lane-major."""
    b, m, c = per_stream.shape
    return per_stream.transpose(1, 0, 2).reshape(m, b * c)


def check_equal(name, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (np.argwhere(got != want)[:3].tolist()
                if got.shape == want.shape else None)
        raise AssertionError(f"{name}: output differs from the oracle "
                             f"(got {got.shape}, want {want.shape}, first {diff})")
    log(f"  {name}: {want.shape[0]} frames x {want.shape[1]} lanes byte-equal")


def run_farm(farm, data, chunk, adjusts=None):
    """Feed (B, N, C) int16 in `chunk`-frame chunks, applying
    ``adjusts[i]`` before chunk i, then flush; returns (M, B*C) lanes."""
    outs = []
    for i, lo in enumerate(range(0, data.shape[1], chunk)):
        if adjusts and i in adjusts:
            assert farm.adjust(*adjusts[i])
        outs.append(farm.process(data[:, lo : lo + chunk]))
    outs.append(farm.flush())
    return lanes_of(np.concatenate(outs, axis=1))


def streams(rng, b, n, c=2):
    return rng.integers(-32768, 32768, size=(b, n, c), dtype=np.int16)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(count):
    devs = jax.devices()
    log("devices:", devs)
    log("device_kind:", devs[0].device_kind, "count:", len(devs))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("nvidia-smi:", smi.replace("\n", " | "))
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(f"needs {count} GPU(s); JAX found {devs}")


def phase_reciprocal():
    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.utils.profiling import median_seconds

    block = 1 << 24

    @jax.jit
    def mismatches(lo):
        m = lo + jnp.arange(block, dtype=jnp.int32)
        want = (jnp.uint32(1 << 31) // m.astype(jnp.uint32)).astype(jnp.int32)
        neg = fx.reciprocal_q31(-m) != -want
        return jnp.sum((fx.reciprocal_q31(m) != want) | neg)

    bad = sum(int(mismatches(jnp.int32(lo))) for lo in range(2, 1 << 28, block))
    if bad:
        raise AssertionError(f"reciprocal_q31: {bad} mismatches over [2, 2^28]")
    log("  reciprocal_q31(+-m) == +-(0x80000000 / m) for every m in [2, 2^28]")

    recip = jax.jit(fx.reciprocal_q31)
    div = jax.jit(lambda m: (jnp.uint32(1 << 31) // m.astype(jnp.uint32)).astype(jnp.int32))
    for n in (4096, 1 << 24):
        m = jnp.arange(2, n + 2, dtype=jnp.int32) * 37
        log(f"  time over {n} denominators: reciprocal_q31 "
            f"{median_seconds(lambda: recip(m)) * 1e6:.2f} us, integer division "
            f"{median_seconds(lambda: div(m)) * 1e6:.2f} us")


def phase_goldens():
    import clownresampler_tpu as crt
    from clownresampler_tpu.utils.audio_io import read_raw_s16le

    pcm = read_raw_s16le("tests/fixtures/test_pcm_s16le.raw", channels=2)
    for rates, want in [((44100, 8000, 44100), "470b7980951007f7074affc666424004"),
                        ((8000, 44100, 44100), "949de6c35cf5bd547e5a1e9a04233c14")]:
        out = crt.resample_array(pcm, *rates)
        md5 = hashlib.md5(np.asarray(out, dtype="<i4").tobytes()).hexdigest()
        if md5 != want:
            raise AssertionError(f"golden {rates}: md5 {md5} != {want}")
        log(f"  resample_array {rates[0]}->{rates[1]}: md5 {md5} (C reference)")


def farm_case(name, rng, b, rates, chunk=4096, n_chunks=4, **kw):
    from clownresampler_tpu.farm import UniformStreamFarm

    data = streams(rng, b, chunk * n_chunks)
    farm = UniformStreamFarm(b, 2, *rates, chunk_frames=chunk, **kw)
    got = run_farm(farm, data, chunk)
    want = oracle_farm(lanes_of(data), [(chunk, rates)] + [(chunk, None)] * (n_chunks - 1),
                       farm._radius_bound)
    check_equal(name, got, want)


def phase_headline(rng):
    farm_case("UniformStreamFarm 1024 x stereo 48k->44.1k", rng, 1024,
              (48000, 44100, 48000))


def phase_classes(rng):
    from clownresampler_tpu.farm import MixedStreamFarm, UniformStreamFarm
    from clownresampler_tpu.highlevel import HighLevelResampler
    from clownresampler_tpu.lowlevel import make_device_state, resample_scan, resample_scan_fused

    # exact stride, general, wide, widest, and a wide exact stride (d=200)
    for b, rates in [(1024, (96000, 48000, 96000)), (1024, (44100, 8000, 44100)),
                     (512, (44100, 132, 44100)), (128, (44100, 44, 44100)),
                     (512, (96000, 480, 96000))]:
        farm_case(f"UniformStreamFarm {b} x stereo {rates[0]}->{rates[1]}", rng, b, rates)

    # pitch bend: a farm re-rated between chunks (config 4's sweep points)
    chunk, r_bound = 4096, 6
    sweep = [(22050, 44100, 88200), (33075, 44100, 88200), (44100, 44100, 88200),
             (66150, 44100, 88200), (88200, 44100, 88200)]
    data = streams(rng, 1024, chunk * len(sweep))
    farm = UniformStreamFarm(1024, 2, *sweep[0], chunk_frames=chunk, max_radius=r_bound)
    got = run_farm(farm, data, chunk, adjusts={i: s for i, s in enumerate(sweep) if i})
    want = oracle_farm(lanes_of(data), [(chunk, s) for s in sweep], r_bound)
    check_equal("UniformStreamFarm pitch-bend adjust 0.5x..2.0x", got, want)

    # mixed-ratio farm: config 5's four groups x 256 stereo, one adjust_stream
    groups = [(48000, 44100, 48000), (44100, 48000, 48000), (8000, 48000, 48000),
              (96000, 48000, 96000)]
    specs = [g for g in groups for _ in range(256)]
    n_chunks, r_bound = 4, 8
    data = streams(rng, len(specs), chunk * n_chunks)
    mixed = MixedStreamFarm(specs, 2, chunk_frames=chunk, max_radius=r_bound)
    outs = [[] for _ in specs]
    bent = (50000, 44100, 50000)
    for k in range(n_chunks):
        if k == 2:
            assert mixed.adjust_stream(0, *bent)
        for i, o in enumerate(mixed.process([d for d in data[:, k * chunk : (k + 1) * chunk]])):
            outs[i].append(o)
    for i, o in enumerate(mixed.flush()):
        outs[i].append(o)
    for g, rates in enumerate(groups):
        members = range(g * 256, (g + 1) * 256)
        kept = [i for i in members if i != 0]        # stream 0 was re-rated
        got = np.concatenate([np.concatenate(outs[i]) for i in kept], axis=1)
        lanes = np.concatenate([data[i] for i in kept], axis=1)
        want = oracle_farm(lanes, [(chunk, rates)] + [(chunk, None)] * (n_chunks - 1), r_bound)
        check_equal(f"MixedStreamFarm group {rates[0]}->{rates[1]}", got, want)
    want = oracle_farm(data[0], [(chunk, groups[0]), (chunk, None), (chunk, bent),
                                 (chunk, None)], r_bound)
    check_equal("MixedStreamFarm adjust_stream(0)", np.concatenate(outs[0]), want)

    # the fused whole-stream scan (config 7's ratio, 1024 stereo streams)
    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.configure import configure

    cfg = configure(44100, 8000, 44100)
    inc = fx.calculate_ratio(44100, 8000)
    r = cfg.integer_stretched_kernel_radius
    taps = fx.round_up(2 * r, 8)
    n_in, k = 4096, 4
    n_cap = fx.round_up(((n_in + 2 * r) << 16) // inc + 16, 128)
    chunks = rng.integers(-32768, 32768, size=(k, n_in, 2048), dtype=np.int16)
    state = make_device_state(0, 0, cfg, inc)
    table = jnp.asarray(TABLE)
    got = resample_scan_fused(table, jnp.asarray(chunks), state, max_taps=taps,
                              n_out=n_cap, radius=r)
    with jax.default_device(CPU):
        want = resample_scan(jnp.asarray(TABLE), jnp.asarray(chunks),
                             jax.device_put(state, CPU), max_taps=taps,
                             n_out=n_cap, radius=r)
    assert not bool(got[3]) and not bool(want[3]), "scan backlog"
    check_equal("resample_scan_fused 44.1k->8k x 2048 lanes (produced)",
                np.asarray(got[1])[None], np.asarray(want[1])[None])
    check_equal("resample_scan_fused 44.1k->8k x 2048 lanes",
                np.asarray(got[0]).reshape(-1, 2048), np.asarray(want[0]).reshape(-1, 2048))

    # HighLevelResampler.resample_stream, bulk route (config 1b's stream)
    mono = rng.integers(-32768, 32768, size=(1 << 18, 1), dtype=np.int16)
    rs = HighLevelResampler.init(1, 48000, 44100, 44100)
    cursor = 0

    def cb(n):
        nonlocal cursor
        got = mono[cursor : cursor + n]
        cursor += got.shape[0]
        return got

    got = rs.resample_stream(cb, bulk=True)
    cfg = configure(48000, 44100, 44100)
    inc = fx.calculate_ratio(48000, 44100)
    r = cfg.integer_stretched_kernel_radius
    padded = np.concatenate([np.zeros((r, 1), np.int16), mono, np.zeros((r, 1), np.int16)])
    n = -(-(mono.shape[0] << 16) // inc)
    check_equal("HighLevelResampler.resample_stream(bulk) 48k->44.1k",
                got, oracle_frames(padded, cfg, inc, 0, 0, n))


def phase_timing(rng):
    """The launch route per ratio class at its benchmark shape: one launch
    over the farm's staging buffer, and one process() through the farm."""
    from clownresampler_tpu.farm import UniformStreamFarm
    from clownresampler_tpu.ops.resample import multi_resample
    from clownresampler_tpu.utils.profiling import median_seconds

    for b, rates in [(1024, (48000, 44100, 48000)), (1024, (96000, 48000, 96000)),
                     (1024, (44100, 8000, 44100)), (512, (44100, 132, 44100)),
                     (128, (44100, 44, 44100))]:
        chunk = streams(rng, b, 4096)
        farm = UniformStreamFarm(b, 2, *rates, chunk_frames=4096)
        farm.process(chunk)
        total = farm._stage(chunk)
        specs = farm._launch_specs(farm._natural_count(total))
        launch = partial(multi_resample, farm._table, (farm._staging,) * len(specs),
                         tuple(s for _, s, _ in specs), tuple(p for _, _, p in specs))
        t_launch = median_seconds(launch)
        farm._emit(total)
        t_process = median_seconds(lambda: farm.process(chunk))
        taps, n_out, _ = specs[0][2]
        log(f"  {b} x stereo {rates[0]}->{rates[1]} ({len(specs)} launch(es) of "
            f"{n_out} frames x {taps} taps): launch {t_launch * 1e3:.4f} ms, "
            f"process() {t_process * 1e3:.3f} ms")


def phase_four_cards(rng):
    """The sharded paths on a dp=4 (or dp=2 x sp=2) mesh, each compared
    byte for byte with the one-card farm or batch in this process."""
    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.batch import make_batch_state, resample_batch
    from clownresampler_tpu.configure import configure
    from clownresampler_tpu.farm import MixedStreamFarm, UniformStreamFarm
    from clownresampler_tpu.parallel import (
        ShardedMixedStreamFarm,
        ShardedStreamFarm,
        make_mesh,
        sharded_resample_batch,
    )
    from clownresampler_tpu.parallel.farm import _sharded_launch

    def one_shard_per_card(name, arr, lanes):
        shards = arr.addressable_shards
        devs = {s.device for s in shards}
        widths = {s.data.shape[-1] for s in shards}
        if len(devs) != 4 or widths != {lanes // 4}:
            raise AssertionError(f"{name}: shards {[(s.device, s.data.shape) for s in shards]}")
        log(f"  {name}: one {lanes // 4}-lane shard on each of {len(devs)} cards")

    mesh = make_mesh(dp=4)
    chunk, b = 4096, 4096
    data = streams(rng, b, chunk * 3)
    sharded = ShardedStreamFarm(mesh, b, 2, 48000, 44100, chunk_frames=chunk)
    total = sharded._stage(data[:, :chunk])
    one_shard_per_card("ShardedStreamFarm staging", sharded._staging, 2 * b)
    specs = sharded._launch_specs(sharded._natural_count(total))
    plans = tuple(p for _, _, p in specs)
    out = _sharded_launch(mesh, plans, len(plans))(
        sharded._table, (sharded._staging,) * len(plans),
        tuple(s for _, s, _ in specs))[0]
    one_shard_per_card("ShardedStreamFarm launch output", out, 2 * b)
    sharded = ShardedStreamFarm(mesh, b, 2, 48000, 44100, chunk_frames=chunk)
    single = UniformStreamFarm(b, 2, 48000, 44100, chunk_frames=chunk)
    check_equal("ShardedStreamFarm 4096 x stereo 48k->44.1k vs one card",
                run_farm(sharded, data, chunk), run_farm(single, data, chunk))

    specs = [(48000, 44100)] * 512 + [(96000, 48000)] * 512
    data = streams(rng, len(specs), chunk * 3)
    got_m = ShardedMixedStreamFarm(mesh, specs, 2, chunk_frames=chunk)
    ref_m = MixedStreamFarm(specs, 2, chunk_frames=chunk)
    got, want = [[] for _ in specs], [[] for _ in specs]
    for k in range(3):
        part = [d for d in data[:, k * chunk : (k + 1) * chunk]]
        for acc, farm in ((got, got_m), (want, ref_m)):
            for i, o in enumerate(farm.process(part)):
                acc[i].append(o)
    for acc, farm in ((got, got_m), (want, ref_m)):
        for i, o in enumerate(farm.flush()):
            acc[i].append(o)
    for farm, _ in got_m._groups:
        one_shard_per_card("ShardedMixedStreamFarm group staging", farm._staging, farm._lanes)
    check_equal("ShardedMixedStreamFarm 48k->44.1k + 96k->48k vs one card",
                np.concatenate([np.concatenate(o) for o in got]),
                np.concatenate([np.concatenate(o) for o in want]))

    ratios = [(48000, 44100), (8000, 44100), (96000, 48000), (44100, 48000)]
    bsz, n_in, n_out = 64, 8192, 8192
    cfgs = [(configure(a, o, max(a, o)), fx.calculate_ratio(a, o))
            for a, o in ratios * (bsz // 4)]
    r_max = max(c.integer_stretched_kernel_radius for c, _ in cfgs)
    buf = np.zeros((bsz, n_in + 2 * r_max, 2), np.int16)
    buf[:, r_max : r_max + n_in] = streams(rng, bsz, n_in)
    args = (jnp.asarray(TABLE), jnp.asarray(buf), jnp.full((bsz,), n_in, jnp.int32),
            make_batch_state(cfgs), jnp.full((bsz,), 1 << 30, jnp.int32))
    taps = fx.round_up(2 * r_max, 8)
    want = resample_batch(*args, max_taps=taps, n_out=n_out)
    got = sharded_resample_batch(make_mesh(dp=2, sp=2), *args, max_taps=taps, n_out=n_out)
    if len(got[0].sharding.device_set) != 4:
        raise AssertionError(f"sharded_resample_batch output on {got[0].sharding.device_set}")
    flat = lambda tree: np.concatenate(
        [np.asarray(leaf).reshape(bsz, -1) for leaf in jax.tree.leaves(tree)], axis=1)
    check_equal("sharded_resample_batch dp=2 x sp=2 (outputs, counts, states)",
                flat(got), flat(want))


def main() -> int:
    global CPU, TABLE
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four GPUs")
    args = parser.parse_args()
    count = 4 if args.four_cards else 1

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {jax.devices()}", file=sys.stderr)
        return 2
    from clownresampler_tpu import platform
    from clownresampler_tpu.models import lanczos_kernel_table

    platform.enable_compile_cache()
    CPU = jax.devices("cpu")[0]
    TABLE = np.asarray(lanczos_kernel_table())
    rng = np.random.default_rng(20261016)

    log("== device");         phase_device(count)
    if args.four_cards:
        log("== four cards");  phase_four_cards(rng)
    else:
        log("== reciprocal");  phase_reciprocal()
        log("== goldens");     phase_goldens()
        log("== headline farm"); phase_headline(rng)
        log("== ratio classes and paths"); phase_classes(rng)
        log("== timing (median host clock, after warm-up)"); phase_timing(rng)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
