"""The uniform-ratio launch route must match the XLA oracle bit-for-bit.

The route runs here compiled for the CPU; chip_smoke.py runs it compiled
for the GPU at the benchmark shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu import platform
from clownresampler_tpu.configure import configure
from clownresampler_tpu.lowlevel import make_device_state
from clownresampler_tpu.models import lanczos_kernel_table
from clownresampler_tpu.ops.convolve import convolve_frames
from clownresampler_tpu.ops.resample import (
    lanes_launch_frames,
    launch_rows,
    multi_resample,
    plan_launch,
    precompute_launch,
    resample_lanes,
)

TILED_RATIOS = [
    (48000, 44100),   # headline: d=1
    (8000, 44100),    # upsample: d=0
    (44100, 48000),   # near-unity upsample
    (44100, 44100),   # unity: d=1, lo=0
    (65521, 65537),   # prime near-unity
    (32000, 48000),
]

STRIDED_RATIOS = [(96000, 48000), (2, 1), (3, 1), (132300, 44100)]


def _setup(in_rate, out_rate, n_out=64, lanes=128, seed=3, p0=0, f0=0):
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    state = make_device_state(p0, f0, cfg, inc)
    max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    s = p0 + ((n_out * inc) >> 16) + 2 * cfg.integer_stretched_kernel_radius + 64
    s = fx.round_up(s, 16)
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, size=(s, lanes)).astype(np.int32)
    return cfg, inc, state, max_taps, jnp.asarray(x)


def _oracle(table, x, state, max_taps, n_out):
    n = jnp.arange(n_out, dtype=jnp.int32)
    pos, frac = fx.positions_from_state(
        state.position_integer,
        state.position_fractional,
        state.cfg.increment_hi,
        state.cfg.increment_lo,
        n,
    )
    return convolve_frames(table, x, pos, frac, state.cfg, max_taps)


@pytest.mark.parametrize("lanes", [128, 3])
@pytest.mark.parametrize("in_rate,out_rate", TILED_RATIOS)
def test_tiled_kernel_bit_exact(in_rate, out_rate, lanes):
    """Every near-unity and upsampling ratio (the headline class) through
    the lanes route, at a wide and at an odd lane count (no lane padding)."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, lanes=lanes)
    want = np.asarray(_oracle(table, x, state, max_taps, 64))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=64)
    np.testing.assert_array_equal(np.asarray(got), want, err_msg=str((in_rate, out_rate)))


@pytest.mark.parametrize("in_rate,out_rate", STRIDED_RATIOS)
def test_strided_path_bit_exact(in_rate, out_rate):
    """Exact integer strides (constant phase fraction) through the lanes
    route."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate)
    assert inc & 0xFFFF == 0 and inc >> 16 >= 2
    n_out = 64
    want = np.asarray(_oracle(table, x, state, max_taps, n_out))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=n_out)
    np.testing.assert_array_equal(np.asarray(got), want, err_msg=str((in_rate, out_rate)))


@pytest.mark.parametrize("in_rate,out_rate", STRIDED_RATIOS + [(176400, 44100), (529200, 44100)])
@pytest.mark.parametrize("p0", [0, 1, 5])
def test_strided_phases_bit_exact(in_rate, out_rate, p0):
    """Strides d=2..12 from initial positions covering every phase residue,
    through multi_resample (the farms' entry), vs the oracle."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, lanes=256, seed=9, p0=p0)
    want = np.asarray(_oracle(table, x, state, max_taps, 64))
    (got,) = multi_resample(table, (x,), (state,), (plan_launch(max_taps, 64, False),))
    np.testing.assert_array_equal(np.asarray(got), want,
                                  err_msg=f"{in_rate}->{out_rate} p0={p0}")


def test_strided_phases_random_fuzz():
    """Random integer strides, initial phases and low-pass stretches through
    the lanes route vs the oracle (complements the curated ratios)."""
    table = jnp.asarray(lanczos_kernel_table())
    rng = np.random.default_rng(71)
    n_out, checked = 64, 0
    for _ in range(10):
        d = int(rng.integers(2, 17))
        out_rate = int(rng.integers(500, 4000))
        in_rate = d * out_rate
        # lpf below out_rate stretches the kernel (more taps, smaller step)
        lpf = int(rng.integers(max(200, out_rate // 3), in_rate))
        cfg = configure(in_rate, out_rate, lpf)
        if cfg is None:
            continue
        inc = fx.calculate_ratio(in_rate, out_rate)
        assert inc & 0xFFFF == 0 and (inc >> 16) == d
        max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
        p0 = int(rng.integers(0, 3 * d))
        f0 = int(rng.integers(0, 1 << 16))
        state = make_device_state(p0, f0, cfg, inc)
        s = fx.round_up(p0 + ((n_out * inc) >> 16) + max_taps + 64, 16)
        x = jnp.asarray(rng.integers(-32768, 32768, size=(s, 128)).astype(np.int32))
        want = np.asarray(_oracle(table, x, state, max_taps, n_out))
        got = resample_lanes(table, x, state, max_taps=max_taps, n_out=n_out)
        np.testing.assert_array_equal(
            np.asarray(got), want,
            err_msg=f"d={d} lpf={lpf} p0={p0} f0={f0} taps={max_taps}")
        checked += 1
    assert checked >= 5


def test_multi_resample_strided_span_contract():
    """An input of EXACTLY the rows a stride-2 launch reads (no slack rows)
    stays bit-exact: window rows may only be clamped for padding frames,
    and here every frame is legal."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg = configure(96000, 48000, 96000)
    inc = fx.calculate_ratio(96000, 48000)
    max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    n_out = 512
    state = make_device_state(0, 0, cfg, inc)
    rows0 = int(precompute_launch(table, state, max_taps=max_taps, n_out=8)[0][0])
    s = rows0 + (n_out - 1) * 2 + max_taps
    rng = np.random.default_rng(23)
    x = jnp.asarray(rng.integers(-32768, 32768, size=(s, 128)).astype(np.int32))
    want = np.asarray(_oracle(table, x, state, max_taps, n_out))
    (got,) = multi_resample(
        table, (x,), (state,), (plan_launch(max_taps, n_out, False),))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_multi_resample_strided_dispatch():
    """multi_resample at an exact stride matches the oracle mid-stream."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(96000, 48000, p0=5, f0=0x1234)
    want = np.asarray(_oracle(table, x, state, max_taps, 64))
    (got,) = multi_resample(
        table, (x,), (state,), (plan_launch(max_taps, 64, False),))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("lanes", [128, 5])
def test_tiled_kernel_nonzero_initial_phase(lanes):
    """Mid-stream launches start at arbitrary (pos, frac)."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg = configure(48000, 44100, 44100)
    inc = fx.calculate_ratio(48000, 44100)
    rng = np.random.default_rng(17)
    x = jnp.asarray(rng.integers(-32768, 32768, size=(192, lanes)).astype(np.int32))
    for p0, f0 in [(3, 0x8421), (0, 0xFFFF), (11, 1)]:
        state = make_device_state(p0, f0, cfg, inc)
        want = np.asarray(_oracle(table, x, state, 8, 64))
        got = resample_lanes(table, x, state, max_taps=8, n_out=64)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str((p0, f0)))


@pytest.mark.parametrize("platform_name", ["cpu", "gpu"])
def test_route_choice_by_platform(platform_name, monkeypatch):
    """The platform module picks the defaults: device-resident farm staging
    and the bulk stream route on the GPU, host staging and the host chunk
    loop on the CPU; the launch plans are the same on both."""
    from clownresampler_tpu.farm import UniformStreamFarm
    from clownresampler_tpu.highlevel import HighLevelResampler

    monkeypatch.setattr(platform, "backend", lambda: platform_name)
    gpu = platform_name == "gpu"
    farm = UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=64)
    assert farm._device_staging == gpu
    assert isinstance(farm._staging, np.ndarray) != gpu
    assert [p for _, _, p in farm._launch_specs(64)] == [(8, 64, False)]
    used_bulk = []
    rs = HighLevelResampler.init(1, 48000, 44100, 48000)
    monkeypatch.setattr(rs, "_resample_stream_bulk",
                        lambda cb: used_bulk.append(1) or (None, cb))
    rs.resample_stream(lambda n: np.zeros((0, 1), np.int16))
    assert bool(used_bulk) == gpu


def test_unsupported_backend_refused(monkeypatch):
    """Nothing runs on a backend the package was not built for."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.backend()
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.on_accelerator()


@pytest.mark.parametrize("in_rate,out_rate,p0,f0", [
    (44100, 132, 0, 0),       # radius 1003 (the C-oracle ll_wide ratio class)
    (44100, 132, 7, 0x8421),  # unaligned window starts / mid-stream phase
    (44100, 44, 3, 0x1111),   # radius 3007 — the widest default-model ratio
    (96000, 480, 5, 0),       # wide integer stride through the lanes route
])
def test_wide_taps_kernel_bit_exact(in_rate, out_rate, p0, f0):
    """The lanes route (XLA) at the widest accepted ratios
    (clownresampler.h:974-975: stretched radius up to 3007 at defaults)."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, n_out=8, p0=p0, f0=f0,
                                          seed=91)
    assert max_taps > 1024, "case must exercise a wide window"
    want = np.asarray(_oracle(table, x, state, max_taps, 8))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=8)
    np.testing.assert_array_equal(
        np.asarray(got), want, err_msg=f"{in_rate}->{out_rate} p0={p0} f0={f0}")


@pytest.mark.parametrize("in_rate,out_rate,p0,f0", [
    (44100, 517, 5, 0x4321),   # taps 512
    (44100, 349, 0, 0),        # taps 760
    (44100, 262, 9, 0x8421),   # taps 1016
])
def test_wide_taps_kernel_medium_widths_bit_exact(in_rate, out_rate, p0, f0):
    """The lanes route (XLA) at medium tap widths."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, n_out=16, p0=p0, f0=f0,
                                          seed=23)
    assert 248 < max_taps <= 1024, "case must sit in the medium-width band"
    want = np.asarray(_oracle(table, x, state, max_taps, 16))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=16)
    np.testing.assert_array_equal(
        np.asarray(got), want, err_msg=f"{in_rate}->{out_rate} p0={p0} f0={f0}")


@pytest.mark.parametrize("in_rate,out_rate,n_out,lanes_n", [
    (44100, 132, 24, 3),     # taps 2008, odd lane count
    (44100, 44, 16, 1),      # radius 3007, one lane
    (44100, 349, 16, 200),   # medium band (taps 760)
])
def test_wide_taps_odd_lanes_bit_exact(in_rate, out_rate, n_out, lanes_n):
    """The lanes route at wide tap counts and lane counts that no vector
    width divides, mid-stream."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, n_out=n_out,
                                          lanes=lanes_n, p0=3, f0=0x7531, seed=29)
    want = np.asarray(_oracle(table, x, state, max_taps, n_out))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=n_out)
    np.testing.assert_array_equal(
        np.asarray(got), want,
        err_msg=f"{in_rate}->{out_rate} n_out={n_out} lanes={lanes_n}")


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (96000, 48000)])
def test_tiled_kernel_clamped_output(in_rate, out_rate):
    """clamp_s16=True == clipping the wide output (fused serving path), at
    a near ratio and at an exact stride."""
    table = jnp.asarray(lanczos_kernel_table())
    cfg, inc, state, max_taps, x = _setup(in_rate, out_rate, seed=44)
    x = x * 4 // 3   # past full scale, so the clamp really clips
    plans = [plan_launch(max_taps, 64, c) for c in (False, True)]
    wide, clamped = multi_resample(table, (x, x), (state, state), tuple(plans))
    assert clamped.dtype == jnp.int16
    want = np.clip(np.asarray(wide), -0x7FFF, 0x7FFF).astype(np.int16)
    assert (np.abs(np.asarray(wide)) > 0x7FFF).any(), "case must clip"
    np.testing.assert_array_equal(np.asarray(clamped), want)


@pytest.mark.parametrize("route_name,clamp,lanes", [
    ("lanes", False, 200), ("lanes", True, 3), ("strided", True, 1),
])
def test_multi_resample_output_shapes(route_name, clamp, lanes):
    """Every launch returns (n_out, L) for any lane count: int32 wide
    samples, or int16 with the clamp ("strided": an exact-stride ratio)."""
    table = jnp.asarray(lanczos_kernel_table())
    rates = (44100, 8000) if route_name == "lanes" else (96000, 48000)
    cfg, inc, state, max_taps, x = _setup(*rates, n_out=40, lanes=lanes)
    (got,) = multi_resample(
        table, (x,), (state,), (plan_launch(max_taps, 40, clamp),))
    assert got.shape == (40, lanes)
    assert got.dtype == (jnp.int16 if clamp else jnp.int32)


def test_multi_resample_mixed_routes():
    """Launches of different ratio classes and tap widths fused into ONE
    multi_resample program == each launch run alone."""
    table = jnp.asarray(lanczos_kernel_table())
    launches = []
    for i, o in [(48000, 44100), (96000, 48000), (44100, 8000)]:
        cfg, inc, state, max_taps, x = _setup(i, o, n_out=128, lanes=64)
        launches.append((x, state, plan_launch(max_taps, 128, False)))
    outs = multi_resample(table, *map(tuple, zip(*launches)))
    for (x, state, plan), got in zip(launches, outs):
        want = np.asarray(_oracle(table, x, state, plan[0], 128))
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(plan))


def test_launch_rows_clamps_only_padding():
    """launch_rows clamps only past-the-end windows: rows that fit are
    untouched, and a clamped window still lies inside the input."""
    rows = jnp.asarray([0, 5, 90, 93, 200], jnp.int32)
    got = np.asarray(launch_rows(rows, 100, 8))
    np.testing.assert_array_equal(got, [0, 5, 90, 92, 92])
    with pytest.raises(AssertionError):
        launch_rows(rows, 7, 8)


def test_lanes_launch_frames_bound():
    """The lanes route's launch-frame bound keeps the (N, T, L) window
    gather under WINDOW_GATHER_BYTES, in multiples of 8, and never below 8
    or above the int32 position bound."""
    from clownresampler_tpu.ops import resample as ops

    assert lanes_launch_frames(8, 2048) == 1 << 14
    n = lanes_launch_frames(2008, 1024)
    assert n % 8 == 0 and n * 2008 * 1024 * 4 <= ops.WINDOW_GATHER_BYTES
    assert lanes_launch_frames(6016, 1 << 20) == 8
    assert lanes_launch_frames(40, 0) == 1 << 14


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (44100, 8000),
                                              (96000, 48000)])
def test_precompute_launch_matches_host_geometry(in_rate, out_rate):
    """precompute_launch's per-frame rows, taps and reciprocals match the
    reference's window geometry computed on the host in exact integers
    (clownresampler.h:993-1025)."""
    table_np = lanczos_kernel_table()
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    p0, f0, n_out = 7, 0x4321, 256
    rows, kvals, q = precompute_launch(
        jnp.asarray(table_np), make_device_state(p0, f0, cfg, inc),
        max_taps=max_taps, n_out=n_out)
    for n in (0, 1, 77, n_out - 1):
        t = f0 + n * inc
        pos, frac = p0 + (t >> 16), t & 0xFFFF
        min_rel = (frac + cfg.stretched_kernel_radius_delta + 0xFFFF) >> 16
        max_rel = (frac + cfg.stretched_kernel_radius) >> 16
        taps = cfg.integer_stretched_kernel_radius + max_rel - min_rel
        start = (cfg.kernel_step_size * ((min_rel << 16) - frac)) >> 16
        k = [int(table_np[start + j * cfg.kernel_step_size]) for j in range(taps)]
        assert int(rows[n]) == pos + min_rel
        assert np.asarray(kvals[n]).tolist() == k + [0] * (max_taps - taps)
        assert int(q[n]) == (1 << 31) // sum(k)


def test_lanes_route_headline_geometry():
    """The lanes route at the exact headline launch geometry of a farm
    (staging rows, 3768 frames, 8 taps), on a narrow lane slice."""
    from clownresampler_tpu.farm import staging_capacity

    table = jnp.asarray(lanczos_kernel_table())
    cfg = configure(48000, 44100, 48000)
    inc = fx.calculate_ratio(48000, 44100)
    r = cfg.integer_stretched_kernel_radius
    s = staging_capacity(r, 4096, fx.round_up(2 * r, 8))
    state = make_device_state(r + 1, 0x1357, cfg, inc)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.integers(-32768, 32768, size=(s, 20)).astype(np.int32))
    want = np.asarray(_oracle(table, x, state, 8, 3768))
    got = resample_lanes(table, x, state, max_taps=8, n_out=3768)
    np.testing.assert_array_equal(np.asarray(got), want)


def _cache_dir_in_subprocess(code: str, env_dir=None) -> str:
    """jax_compilation_cache_dir as a fresh process sees it after ``code``."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run(
        [sys.executable, "-c", "import jax, clownresampler_tpu; " + code +
         "; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(platform.CACHE_DIR.parent), capture_output=True, text=True,
        env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    return r.stdout.strip()


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(env_dir, tmp_path):
    """An entry point's enable_compile_cache() turns on the persistent
    compile cache: in JAX_COMPILATION_CACHE_DIR when it is set (nothing
    else is set), else in the fixed .jax_cache directory of the checkout."""
    want = tmp_path / env_dir if env_dir else platform.CACHE_DIR
    got = _cache_dir_in_subprocess("clownresampler_tpu.platform.enable_compile_cache()",
                                   want if env_dir else None)
    assert got == str(want)


def test_import_sets_no_compile_cache():
    """Importing the library leaves JAX's compile-cache setting alone."""
    assert _cache_dir_in_subprocess("pass") in ("", "None")
