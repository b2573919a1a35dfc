"""ShardedStreamFarm (lanes over a dp mesh) must be bit-equal to the
single-device UniformStreamFarm — and transitively to the C reference per
stream — on the 8-virtual-device CPU mesh (conftest)."""

import numpy as np
import pytest

from clownresampler_tpu.farm import UniformStreamFarm
from clownresampler_tpu.parallel import ShardedStreamFarm, make_mesh


def _run(farm, chunks):
    outs = [farm.process(c) for c in chunks]
    outs.append(farm.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize(
    "in_rate,out_rate",
    [
        (48000, 44100),   # near class
        (96000, 48000),   # exact stride d=2
        (44100, 8000),    # general class
    ],
)
def test_sharded_farm_matches_uniform_farm(in_rate, out_rate):
    mesh = make_mesh()  # all 8 CPU-mesh devices on dp
    n_streams, channels, chunk = 512, 2, 384
    rng = np.random.default_rng(11)
    chunks = [
        rng.integers(-32768, 32768, (n_streams, chunk, channels)).astype(np.int16)
        for _ in range(3)
    ]
    ref_farm = UniformStreamFarm(
        n_streams, channels, in_rate, out_rate,
        chunk_frames=chunk,
    )
    sh_farm = ShardedStreamFarm(
        mesh, n_streams, channels, in_rate, out_rate,
        chunk_frames=chunk,
    )
    assert sh_farm._lanes % mesh.shape["dp"] == 0
    want = _run(ref_farm, chunks)
    got = _run(sh_farm, chunks)
    np.testing.assert_array_equal(got, want, err_msg=f"{in_rate}->{out_rate}")


def test_sharded_farm_medium_width_wide_dispatch():
    """A medium tap width (760) through the shard-mapped launch, with a lane
    count that pads up to whole shards (509 streams over 8 devices) — still
    bit-equal to the single-device farm."""
    mesh = make_mesh()
    n_streams, channels, chunk = 509, 1, 2048
    in_rate, out_rate = 44100, 349          # taps 760: medium band
    rng = np.random.default_rng(17)
    chunks = [
        rng.integers(-32768, 32768, (n_streams, chunk, channels)).astype(np.int16)
        for _ in range(2)
    ]
    ref_farm = UniformStreamFarm(
        n_streams, channels, in_rate, out_rate,
        chunk_frames=chunk,
    )
    sh_farm = ShardedStreamFarm(
        mesh, n_streams, channels, in_rate, out_rate,
        chunk_frames=chunk,
    )
    assert sh_farm._lanes == 512 and ref_farm._lanes == 509
    (_, _, plan), = sh_farm._launch_specs(8)
    assert plan[0] == 760, plan
    np.testing.assert_array_equal(_run(sh_farm, chunks), _run(ref_farm, chunks))


def test_sharded_farm_adjust_pitch_bend():
    """Mid-stream adjust (position carry) matches the single-device farm."""
    mesh = make_mesh()
    n_streams, channels, chunk = 512, 1, 384
    rng = np.random.default_rng(13)
    chunks = [
        rng.integers(-32768, 32768, (n_streams, chunk, channels)).astype(np.int16)
        for _ in range(3)
    ]
    rates = [(48000, 44100), (96000, 48000), (32000, 48000)]

    def run(farm):
        outs = []
        for (ir, orate), c in zip(rates, chunks):
            assert farm.adjust(ir, orate, max(ir, orate))
            outs.append(farm.process(c))
        outs.append(farm.flush())
        return np.concatenate(outs, axis=1)

    ref_farm = UniformStreamFarm(
        n_streams, channels, 48000, 44100,
        chunk_frames=chunk, max_radius=8,
    )
    sh_farm = ShardedStreamFarm(
        mesh, n_streams, channels, 48000, 44100,
        chunk_frames=chunk, max_radius=8,
    )
    np.testing.assert_array_equal(run(sh_farm), run(ref_farm))


def test_sharded_mixed_farm_matches_mixed_farm():
    """ShardedMixedStreamFarm (per-ratio-group lane sharding, one fused
    shard-mapped launch per chunk) == MixedStreamFarm per stream, including
    a mid-stream per-stream adjust (the migrating stream lands in its own
    sharded solo farm)."""
    from clownresampler_tpu.farm import MixedStreamFarm
    from clownresampler_tpu.parallel import ShardedMixedStreamFarm

    mesh = make_mesh()
    ch, chunk, n_chunks = 2, 384, 3
    # 2 ratio groups x enough streams to give every device a lane shard
    specs = [(48000, 44100)] * 512 + [(96000, 48000)] * 512
    rng = np.random.default_rng(19)
    data = [
        rng.integers(-32768, 32768, (n_chunks * chunk, ch)).astype(np.int16)
        for _ in specs
    ]

    def run(farm):
        outs = [[] for _ in specs]
        for k in range(n_chunks):
            if k == 1:
                assert farm.adjust_stream(0, 32000, 48000)
            res = farm.process([d[k * chunk : (k + 1) * chunk] for d in data])
            for i, r in enumerate(res):
                outs[i].append(r)
        for i, r in enumerate(farm.flush()):
            outs[i].append(r)
        return [np.concatenate(o, axis=0) for o in outs]

    ref = MixedStreamFarm(specs, ch, chunk_frames=chunk,
                          max_radius=8)
    sh = ShardedMixedStreamFarm(mesh, specs, ch, chunk_frames=chunk, max_radius=8)
    want = run(ref)
    got = run(sh)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")


def test_sharded_farm_clamp_s16():
    """clamp_s16 through the shard-mapped launch == clipping the wide farm."""
    mesh = make_mesh()
    n_streams, ch, chunk = 512, 1, 256
    rng = np.random.default_rng(17)
    data = rng.integers(-32768, 32768, (n_streams, chunk, ch)).astype(np.int16)
    wide = ShardedStreamFarm(mesh, n_streams, ch, 48000, 44100,
                             chunk_frames=chunk)
    clamped = ShardedStreamFarm(mesh, n_streams, ch, 48000, 44100,
                                chunk_frames=chunk,
                                clamp_s16=True)
    a = np.concatenate([wide.process(data), wide.flush()], axis=1)
    b = np.concatenate([clamped.process(data), clamped.flush()], axis=1)
    assert b.dtype == np.int16
    np.testing.assert_array_equal(b, np.clip(a, -0x7FFF, 0x7FFF).astype(np.int16))


def test_sharded_farm_wide_kernel_class():
    """A wide tap width (44100->256: radius 517, taps 1040) through the
    shard-mapped launch == the single-device farm."""
    mesh = make_mesh()
    n_streams, channels, chunk = 1024, 1, 3072
    rng = np.random.default_rng(23)
    chunks = [
        rng.integers(-32768, 32768, (n_streams, chunk, channels)).astype(np.int16)
        for _ in range(2)
    ]
    ref_farm = UniformStreamFarm(
        n_streams, channels, 44100, 256, chunk_frames=chunk,
    )
    assert ref_farm._max_taps > 1024, "case must exercise a wide window"
    sh_farm = ShardedStreamFarm(
        mesh, n_streams, channels, 44100, 256,
        chunk_frames=chunk,
    )
    want = _run(ref_farm, chunks)
    got = _run(sh_farm, chunks)
    np.testing.assert_array_equal(got, want)
