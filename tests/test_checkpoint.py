"""Checkpoint/resume: restored state continues bit-identically."""

import numpy as np

from clownresampler_tpu.checkpoint import (
    load_farm,
    load_highlevel,
    load_lowlevel,
    save_farm,
    save_highlevel,
    save_lowlevel,
)
from clownresampler_tpu.farm import UniformStreamFarm
from clownresampler_tpu.highlevel import HighLevelResampler
from clownresampler_tpu.lowlevel import LowLevelResampler


def test_lowlevel_roundtrip_continues():
    rng = np.random.default_rng(0)
    data = rng.integers(-32768, 32768, size=(500, 2)).astype(np.int16)
    r = 17
    padded = np.concatenate([np.zeros((r, 2), np.int16), data, np.zeros((r, 2), np.int16)])

    a = LowLevelResampler.init(2, 44100, 8000, 44100)
    _, rem, first = a.resample(padded[: 300 + 2 * r], 300)
    b = load_lowlevel(save_lowlevel(a))

    consumed = 300 - rem
    _, _, rest_a = a.resample(padded[consumed:], 500 - consumed)
    _, _, rest_b = b.resample(padded[consumed:], 500 - consumed)
    np.testing.assert_array_equal(rest_a, rest_b)


def test_highlevel_roundtrip_continues():
    rng = np.random.default_rng(1)
    data = rng.integers(-32768, 32768, size=(800, 2)).astype(np.int16)
    state = {"c": 0}

    def cb(n):
        give = min(n, data.shape[0] - state["c"])
        out = data[state["c"] : state["c"] + give]
        state["c"] += give
        return out

    a = HighLevelResampler.init(2, 44100, 8000, 44100)
    got_a = []
    a.resample(cb, output_limit=100, _collect=got_a)

    b = load_highlevel(save_highlevel(a))
    cont_a, cont_b = [], []
    state_b = dict(state)

    def cb_b(n):
        give = min(n, data.shape[0] - state_b["c"])
        out = data[state_b["c"] : state_b["c"] + give]
        state_b["c"] += give
        return out

    a.resample(cb, _collect=cont_a)
    a.resample_end(_collect=cont_a)
    b.resample(cb_b, _collect=cont_b)
    b.resample_end(_collect=cont_b)
    np.testing.assert_array_equal(
        np.concatenate(cont_a, axis=0), np.concatenate(cont_b, axis=0)
    )


def test_farm_roundtrip_continues():
    rng = np.random.default_rng(2)
    data = rng.integers(-32768, 32768, size=(3, 600, 2)).astype(np.int16)
    a = UniformStreamFarm(3, 2, 48000, 44100, chunk_frames=256)
    a.process(data[:, :256])
    b = load_farm(save_farm(a))
    out_a = [a.process(data[:, 256:512]), a.process(data[:, 512:]), a.flush()]
    out_b = [b.process(data[:, 256:512]), b.process(data[:, 512:]), b.flush()]
    np.testing.assert_array_equal(
        np.concatenate(out_a, axis=1), np.concatenate(out_b, axis=1)
    )


def test_lowlevel_roundtrip_preserves_model():
    """Review regression: restoring a non-default-model resampler must keep
    its kernel table (previously silently reverted to the default LUT)."""
    from clownresampler_tpu.models import HIGH_QUALITY_MODEL

    rng = np.random.default_rng(7)
    data = rng.integers(-32768, 32768, size=(200, 2)).astype(np.int16)
    a = LowLevelResampler.init(2, 48000, 44100, 48000, model=HIGH_QUALITY_MODEL)
    r = a.config.integer_stretched_kernel_radius
    padded = np.concatenate([np.zeros((r, 2), np.int16), data, np.zeros((r, 2), np.int16)])
    b = load_lowlevel(save_lowlevel(a))
    assert b.model == a.model
    _, _, out_a = a.resample(padded, 200)
    _, _, out_b = b.resample(padded, 200)
    np.testing.assert_array_equal(out_a, out_b)


def test_mixed_farm_checkpoint_resume():
    """Mixed-farm save/restore continues bit-identically, incl. a stream
    split off by adjust_stream."""
    import numpy as np

    from clownresampler_tpu.checkpoint import load_mixed_farm, save_mixed_farm
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(51)
    ch, chunk = 2, 256
    specs = [(48000, 44100), (48000, 44100), (8000, 44100)]
    data = [rng.integers(-32768, 32768, size=(3 * chunk, ch)).astype(np.int16)
            for _ in specs]

    a = MixedStreamFarm(specs, ch, chunk_frames=chunk, max_radius=8)
    a.process([d[:chunk] for d in data])
    assert a.adjust_stream(1, 96000, 48000)

    b = load_mixed_farm(save_mixed_farm(a))
    out_a, out_b = [], []
    for farm, sink in ((a, out_a), (b, out_b)):
        for k in (1, 2):
            sink.append(farm.process([d[k * chunk : (k + 1) * chunk] for d in data]))
        sink.append(farm.flush())
    for step_a, step_b in zip(out_a, out_b):
        for ra, rb in zip(step_a, step_b):
            np.testing.assert_array_equal(ra, rb)


def test_sharded_mixed_farm_checkpoint_resume():
    """A mixed-farm checkpoint restores onto a device mesh
    (ShardedMixedStreamFarm) and continues bit-identically to the plain
    mixed restore, incl. a stream split off by adjust_stream."""
    import numpy as np

    from clownresampler_tpu.checkpoint import load_mixed_farm, save_mixed_farm
    from clownresampler_tpu.parallel import ShardedMixedStreamFarm, make_mesh

    mesh = make_mesh()
    rng = np.random.default_rng(59)
    ch, chunk = 1, 256
    specs = [(48000, 44100)] * 512 + [(96000, 48000)] * 512
    data = [rng.integers(-32768, 32768, size=(2 * chunk, ch)).astype(np.int16)
            for _ in specs]
    a = ShardedMixedStreamFarm(mesh, specs, ch, chunk_frames=chunk, max_radius=8)
    a.process([d[:chunk] for d in data])
    assert a.adjust_stream(0, 32000, 48000)
    snap = save_mixed_farm(a)
    b = load_mixed_farm(snap, mesh=mesh)
    assert isinstance(b, ShardedMixedStreamFarm)
    c = load_mixed_farm(snap)  # plain restore of the same snapshot
    outs = []
    for farm in (a, b, c):
        step = farm.process([d[chunk:] for d in data])
        tail = farm.flush()
        outs.append([np.concatenate([s, t], axis=0) for s, t in zip(step, tail)])
    for i, (ra, rb, rc) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(rb, ra, err_msg=f"sharded stream {i}")
        np.testing.assert_array_equal(rc, ra, err_msg=f"plain stream {i}")


def test_sharded_farm_checkpoint_resume():
    """A farm checkpoint restores onto a device mesh (ShardedStreamFarm) and
    continues bit-identically to the unsharded restore."""
    import numpy as np

    from clownresampler_tpu.checkpoint import load_farm, save_farm
    from clownresampler_tpu.farm import UniformStreamFarm
    from clownresampler_tpu.parallel import ShardedStreamFarm, make_mesh

    mesh = make_mesh()
    rng = np.random.default_rng(53)
    n_streams, ch, chunk = 512, 2, 256
    chunks = [rng.integers(-32768, 32768, (n_streams, chunk, ch)).astype(np.int16)
              for _ in range(2)]
    a = ShardedStreamFarm(mesh, n_streams, ch, 48000, 44100,
                          chunk_frames=chunk)
    a.process(chunks[0])
    snap = save_farm(a)
    b = load_farm(snap, mesh=mesh)
    assert isinstance(b, ShardedStreamFarm)
    c = load_farm(snap)  # plain single-device restore of the same snapshot
    c._device_staging = False
    c._staging = np.array(snap["staging"], dtype=np.int32)
    ra = np.concatenate([a.process(chunks[1]), a.flush()], axis=1)
    rb = np.concatenate([b.process(chunks[1]), b.flush()], axis=1)
    rc = np.concatenate([c.process(chunks[1]), c.flush()], axis=1)
    np.testing.assert_array_equal(rb, ra)
    np.testing.assert_array_equal(rc, ra)


def test_farm_snapshot_with_interpret_key_loads():
    """Snapshots carrying the ``interpret`` key that older versions wrote
    still load and continue bit-identically; new snapshots do not carry
    it."""
    import numpy as np

    from clownresampler_tpu.checkpoint import load_farm, save_farm
    from clownresampler_tpu.farm import UniformStreamFarm

    rng = np.random.default_rng(59)
    chunks = [rng.integers(-32768, 32768, (3, 256, 2)).astype(np.int16)
              for _ in range(2)]
    a = UniformStreamFarm(3, 2, 48000, 44100, chunk_frames=256)
    a.process(chunks[0])
    snap = save_farm(a)
    assert "interpret" not in snap
    b = load_farm(dict(snap, interpret=True))
    ra = np.concatenate([a.process(chunks[1]), a.flush()], axis=1)
    rb = np.concatenate([b.process(chunks[1]), b.flush()], axis=1)
    np.testing.assert_array_equal(rb, ra)
