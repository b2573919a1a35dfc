"""Transcode farm: per-stream bit-exactness against the host low-level path.

Each stream pushed through UniformStreamFarm (chunked, every ratio class,
native or device staging) must produce exactly what the reference produces
for that stream's whole input, computed by the ops.convolve oracle
(tests/oracle.py).
"""

import numpy as np
import pytest

from clownresampler_tpu.farm import UniformStreamFarm
from clownresampler_tpu.lowlevel import LowLevelResampler
from tests import oracle

RATIOS = [
    (48000, 44100),   # near class, d=1
    (8000, 44100),    # near class, d=0
    (96000, 48000),   # exact stride d=2
    (44100, 8000),    # general (d=5, lo != 0)
    (44100, 44100),   # unity
]


def _host_reference(data, channels, in_rate, out_rate, lpf):
    return oracle.convolve_stream(data, in_rate, out_rate, lpf)


@pytest.mark.parametrize("in_rate,out_rate", RATIOS)
def test_farm_matches_host(in_rate, out_rate):
    rng = np.random.default_rng(21)
    b, ch, total = 4, 2, 700
    lpf = max(in_rate, out_rate)
    data = rng.integers(-32768, 32768, size=(b, total, ch)).astype(np.int16)

    farm = UniformStreamFarm(
        b, ch, in_rate, out_rate, lpf, chunk_frames=256
    )
    outs = []
    cursor = 0
    for size in (100, 17, 256, 9, 200, 118):
        outs.append(farm.process(data[:, cursor : cursor + size]))
        cursor += size
    assert cursor == total
    outs.append(farm.flush())
    got = np.concatenate(outs, axis=1)

    for i in range(b):
        want = _host_reference(data[i], ch, in_rate, out_rate, lpf)
        np.testing.assert_array_equal(
            got[i], want, err_msg=f"stream {i} ratio {in_rate}->{out_rate}"
        )


def test_farm_pitch_bend_matches_host():
    """adjust() between chunks == LowLevel_Adjust between chunked resamples."""
    rng = np.random.default_rng(5)
    b, ch, total = 2, 2, 600
    data = rng.integers(-32768, 32768, size=(b, total, ch)).astype(np.int16)
    rates = [(22050, 44100), (33075, 44100), (44100, 44100), (66150, 44100)]

    farm = UniformStreamFarm(
        b, ch, rates[0][0], rates[0][1], 44100, chunk_frames=256,
        max_radius=6,
    )
    outs = []
    cursor = 0
    for i, size in enumerate((150, 150, 150, 150)):
        if i > 0:
            assert farm.adjust(rates[i][0], rates[i][1], 44100)
        outs.append(farm.process(data[:, cursor : cursor + size]))
        cursor += size
    outs.append(farm.flush())
    got = np.concatenate(outs, axis=1)

    # Host mirror: chunked low-level resampling replaying the farm's exact
    # schedule — after each chunk the farm resamples against all received
    # frames minus a trailing hold-back of R_BOUND (its max-radius halo);
    # flush appends R_BOUND zero frames. The adjust points land at the same
    # stream phase iff the visible-frame schedule matches.
    r_bound = 6
    for s in range(b):
        rs = LowLevelResampler.init(ch, rates[0][0], rates[0][1], 44100, max_radius=r_bound)
        padded = np.concatenate(
            [np.zeros((r_bound, ch), np.int16), data[s], np.zeros((r_bound, ch), np.int16)]
        )
        host_frames = []
        consumed = 0
        received = 0
        for i, size in enumerate((150, 150, 150, 150)):
            if i > 0:
                assert rs.adjust(rates[i][0], rates[i][1], 44100)
            received += size
            n_visible = received - consumed - r_bound
            if n_visible <= 0:
                continue
            r = rs.config.integer_stretched_kernel_radius
            start_row = r_bound + consumed - r
            window = padded[start_row : start_row + n_visible + 2 * r]
            _, remaining, frames = rs.resample(window, n_visible)
            host_frames.append(frames)
            consumed += n_visible - remaining
        # flush: the hold-back plus r_bound zeros become visible
        n_visible = (received + r_bound) - consumed - r_bound
        r = rs.config.integer_stretched_kernel_radius
        start_row = r_bound + consumed - r
        window = padded[start_row : start_row + n_visible + 2 * r]
        _, _, frames = rs.resample(window, n_visible)
        host_frames.append(frames)
        want = np.concatenate(host_frames, axis=0)
        np.testing.assert_array_equal(got[s], want, err_msg=f"stream {s}")


def test_farm_rejects_bad_adjust():
    farm = UniformStreamFarm(2, 2, 44100, 44100, 44100, chunk_frames=128)
    assert not farm.adjust(192000, 8000)      # radius beyond bound
    assert farm.adjust(44100, 48000)          # fine


def test_mixed_farm_matches_host():
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(33)
    ch, total = 2, 512
    specs = [(48000, 44100), (8000, 44100), (48000, 44100), (96000, 48000)]
    data = [rng.integers(-32768, 32768, size=(total, ch)).astype(np.int16) for _ in specs]

    farm = MixedStreamFarm(specs, ch, chunk_frames=256)
    outs = [[] for _ in specs]
    for off in (0, 256):
        res = farm.process([d[off : off + 256] for d in data])
        for i, r in enumerate(res):
            outs[i].append(r)
    for i, r in enumerate(farm.flush()):
        outs[i].append(r)

    for i, (in_rate, out_rate) in enumerate(specs):
        got = np.concatenate(outs[i], axis=0)
        want = _host_reference(data[i], ch, in_rate, out_rate, max(in_rate, out_rate))
        np.testing.assert_array_equal(got, want, err_msg=f"stream {i}")


@pytest.mark.parametrize("in_rate,out_rate", [
    (192000, 48000),   # d=4
    (96000, 480),      # d=200, 1200 taps: a wide exact stride
])
def test_farm_strided_extreme_downsample(in_rate, out_rate):
    """Exact integer strides far from unity fit the staging capacity and
    match the oracle (a d=4 farm once sliced past its staging buffer)."""
    rng = np.random.default_rng(41)
    data = rng.integers(-32768, 32768, size=(1, 2048, 1)).astype(np.int16)
    farm = UniformStreamFarm(1, 1, in_rate, out_rate, chunk_frames=512)
    outs = [farm.process(data[:, lo : lo + 512]) for lo in range(0, 2048, 512)]
    out = np.concatenate(outs + [farm.flush()], axis=1)
    want = _host_reference(data[0], 1, in_rate, out_rate, in_rate)
    assert want.shape[0] > 0
    np.testing.assert_array_equal(out[0], want)


def test_farm_launch_tiling_matches_host(monkeypatch):
    """_launch tiles into sub-launches; tiled output == single-launch output.

    Cheap multi-tile exercise: force tiny tiles so one process() crosses many
    sub-launch boundaries (host-side p0/f0 re-derivation between tiles)."""
    from clownresampler_tpu.ops import resample as ops

    monkeypatch.setattr(ops, "MAX_LAUNCH_FRAMES", 64)
    rng = np.random.default_rng(13)
    for in_rate, out_rate in [(44100, 48000), (8000, 44100), (96000, 48000)]:
        data = rng.integers(-32768, 32768, size=(2, 500, 2)).astype(np.int16)
        farm = UniformStreamFarm(2, 2, in_rate, out_rate, chunk_frames=512)
        got = np.concatenate([farm.process(data), farm.flush()], axis=1)
        for i in range(2):
            want = _host_reference(data[i], 2, in_rate, out_rate,
                                   max(in_rate, out_rate))
            np.testing.assert_array_equal(got[i], want,
                                          err_msg=f"{in_rate}->{out_rate} s{i}")


def test_farm_lane_split_matches_host(monkeypatch):
    """A wide fleet whose lanes-route window gather would pass
    WINDOW_GATHER_BYTES splits each emit into several launches of fewer
    frames (odd lane count, no lane padding); output must be identical."""
    from clownresampler_tpu.ops import resample as ops

    monkeypatch.setattr(ops, "WINDOW_GATHER_BYTES", 8 * 8 * 194 * 4 * 5)
    rng = np.random.default_rng(23)
    b, ch, total = 97, 2, 300                 # 194 lanes -> 40-frame launches
    data = rng.integers(-32768, 32768, size=(b, total, ch)).astype(np.int16)
    farm = UniformStreamFarm(b, ch, 48000, 44100, chunk_frames=256)
    assert farm._lanes == 194
    assert len(farm._launch_specs(200)) == 5
    got = np.concatenate(
        [farm.process(data[:, :256]), farm.process(data[:, 256:]), farm.flush()],
        axis=1,
    )
    for i in (0, 63, 96):
        want = _host_reference(data[i], ch, 48000, 44100, 48000)
        np.testing.assert_array_equal(got[i], want, err_msg=f"stream {i}")


def test_farm_large_chunk_int32_safe():
    """Advisor regression: one huge process() must not wrap int32 positions.

    At 44.1k->48k (inc_lo=60211) frame 35665's f0 + n*inc_lo exceeds 2^31;
    the untiled farm silently emitted corrupt audio past that frame."""
    rng = np.random.default_rng(17)
    n = 36000
    data = rng.integers(-32768, 32768, size=(1, n, 1)).astype(np.int16)
    farm = UniformStreamFarm(1, 1, 44100, 48000, chunk_frames=n)
    got = np.concatenate([farm.process(data), farm.flush()], axis=1)
    want = _host_reference(data[0], 1, 44100, 48000, 48000)
    np.testing.assert_array_equal(got[0], want)


def test_farm_device_staging_matches_host_staging():
    """device_staging=True (device-resident buffer) == native host staging."""
    rng = np.random.default_rng(71)
    b, ch, total = 3, 2, 600
    data = rng.integers(-32768, 32768, size=(b, total, ch)).astype(np.int16)

    outs = {}
    for dev in (False, True):
        farm = UniformStreamFarm(
            b, ch, 44100, 48000, 48000, chunk_frames=256,
            device_staging=dev,
        )
        parts = []
        for off in (0, 256, 512):
            parts.append(farm.process(data[:, off : off + min(256, total - off)]))
        parts.append(farm.flush())
        outs[dev] = np.concatenate(parts, axis=1)
    np.testing.assert_array_equal(outs[True], outs[False])

    want = _host_reference(data[1], ch, 44100, 48000, 48000)
    np.testing.assert_array_equal(outs[True][1], want)


def test_farm_clamp_s16_output():
    """clamp_s16 farms emit int16 == clipped wide output, every route."""
    rng = np.random.default_rng(91)
    for in_rate, out_rate in [(48000, 44100), (96000, 48000), (44100, 8000)]:
        data = rng.integers(-32768, 32768, size=(2, 300, 2)).astype(np.int16)
        wide = UniformStreamFarm(2, 2, in_rate, out_rate, chunk_frames=256)
        clamped = UniformStreamFarm(2, 2, in_rate, out_rate, chunk_frames=256,
                                    clamp_s16=True)
        w = np.concatenate([wide.process(data[:, :256]), wide.process(data[:, 256:]),
                            wide.flush()], axis=1)
        c = np.concatenate([clamped.process(data[:, :256]), clamped.process(data[:, 256:]),
                            clamped.flush()], axis=1)
        assert c.dtype == np.int16
        np.testing.assert_array_equal(
            c, np.clip(w, -0x7FFF, 0x7FFF).astype(np.int16), err_msg=str((in_rate, out_rate))
        )


def test_mixed_farm_per_stream_adjust():
    """adjust_stream re-rates ONE stream mid-stream (its position carries,
    clownresampler.h:1052-1056); every stream still matches a per-stream
    UniformStreamFarm driven with the same adjust schedule."""
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(41)
    ch, chunk, n_chunks = 2, 256, 4
    specs = [(48000, 44100), (48000, 44100), (8000, 44100)]
    data = [
        rng.integers(-32768, 32768, size=(n_chunks * chunk, ch)).astype(np.int16)
        for _ in specs
    ]
    # stream 1 re-rates to 96k->48k before chunk 2, then to 32k->48k before
    # chunk 3 (second adjust lands on its private farm); max_radius reserves
    # the widest radius the schedule reaches.
    farm = MixedStreamFarm(specs, ch, chunk_frames=chunk,
                           max_radius=8)
    outs = [[] for _ in specs]
    for k in range(n_chunks):
        if k == 2:
            assert farm.adjust_stream(1, 96000, 48000)
        if k == 3:
            assert farm.adjust_stream(1, 32000, 48000)
        res = farm.process([d[k * chunk : (k + 1) * chunk] for d in data])
        for i, r in enumerate(res):
            outs[i].append(r)
    for i, r in enumerate(farm.flush()):
        outs[i].append(r)

    # per-stream references with the same schedule
    for i, (in_rate, out_rate) in enumerate(specs):
        ref = UniformStreamFarm(1, ch, in_rate, out_rate, chunk_frames=chunk,
                                max_radius=8)
        want = []
        for k in range(n_chunks):
            if i == 1 and k == 2:
                assert ref.adjust(96000, 48000)
            if i == 1 and k == 3:
                assert ref.adjust(32000, 48000)
            want.append(ref.process(data[i][None, k * chunk : (k + 1) * chunk]))
        want.append(ref.flush())
        want_cat = np.concatenate([w[0] for w in want], axis=0)
        got = np.concatenate(outs[i], axis=0)
        np.testing.assert_array_equal(got, want_cat, err_msg=f"stream {i}")


def test_mixed_farm_adjust_stream_capacity_drift():
    """Migrating a stream between a near-class group and an exact-stride solo farm
    (and back) keeps the staging geometry: with chunk_frames=8192 and
    max_radius=30 both farms size their buffers identically and outputs
    stay bit-exact."""
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(53)
    ch, chunk, n_chunks = 1, 512, 3
    for specs, new_rate in [
        # near-primary group, stream 0 re-rates to an integer stride
        ([(48000, 44100), (48000, 44100)], (96000, 48000)),
        # exact-stride primary group, stream 0 re-rates OUT to a near ratio
        ([(96000, 48000), (96000, 48000)], (48000, 44100)),
    ]:
        data = [
            rng.integers(-32768, 32768, size=(n_chunks * chunk, ch)).astype(np.int16)
            for _ in specs
        ]
        farm = MixedStreamFarm(specs, ch, chunk_frames=8192,
                               max_radius=30)
        outs = [[] for _ in specs]
        for k in range(n_chunks):
            if k == 1:
                assert farm.adjust_stream(0, *new_rate)
            res = farm.process([d[k * chunk : (k + 1) * chunk] for d in data])
            for i, r in enumerate(res):
                outs[i].append(r)
        for i, r in enumerate(farm.flush()):
            outs[i].append(r)
        for i, (in_rate, out_rate) in enumerate(specs):
            ref = UniformStreamFarm(1, ch, in_rate, out_rate, chunk_frames=8192,
                                    max_radius=30)
            want = []
            for k in range(n_chunks):
                if i == 0 and k == 1:
                    assert ref.adjust(*new_rate)
                want.append(ref.process(data[i][None, k * chunk : (k + 1) * chunk]))
            want.append(ref.flush())
            np.testing.assert_array_equal(
                np.concatenate(outs[i], axis=0),
                np.concatenate([w[0] for w in want], axis=0),
                err_msg=f"specs={specs} stream {i}")


def test_mixed_farm_adjust_stream_rejects_and_rolls_back():
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(43)
    ch, chunk = 1, 256
    specs = [(48000, 44100), (48000, 44100)]
    data = [rng.integers(-32768, 32768, size=(2 * chunk, ch)).astype(np.int16)
            for _ in specs]
    farm = MixedStreamFarm(specs, ch, chunk_frames=chunk)
    farm.process([d[:chunk] for d in data])
    # radius growth past the construction bound fails, nothing changes
    assert not farm.adjust_stream(0, 44100, 8000)
    assert len(farm._groups) == 1 and farm._groups[0][1] == [0, 1]
    res = farm.process([d[chunk:] for d in data])
    ref = UniformStreamFarm(2, ch, 48000, 44100, chunk_frames=chunk)
    a = ref.process(np.stack([d[:chunk] for d in data]))
    b = ref.process(np.stack([d[chunk:] for d in data]))
    np.testing.assert_array_equal(
        np.concatenate(res, axis=0).reshape(2, -1, ch)[0], b[0],
        err_msg="post-reject chunk")


def test_mixed_farm_clamp_s16():
    from clownresampler_tpu.farm import MixedStreamFarm

    rng = np.random.default_rng(47)
    ch, chunk = 1, 256
    specs = [(48000, 44100), (8000, 44100)]
    data = [rng.integers(-32768, 32768, size=(chunk, ch)).astype(np.int16)
            for _ in specs]
    wide = MixedStreamFarm(specs, ch, chunk_frames=chunk)
    clamped = MixedStreamFarm(specs, ch, chunk_frames=chunk,
                              clamp_s16=True)
    a = wide.process(data)
    b = clamped.process(data)
    for i in range(2):
        assert b[i].dtype == np.int16
        np.testing.assert_array_equal(
            b[i], np.clip(a[i], -0x7FFF, 0x7FFF).astype(np.int16))


def test_farm_large_max_radius_launches_current_width():
    """A farm reserving a wide radius launches at the CURRENT ratio's tap
    width (kernel values past a frame's taps are zero), and its staging
    holds every legal read of the reserve."""
    from clownresampler_tpu.farm import staging_capacity

    farm = UniformStreamFarm(4, 2, 48000, 44100, chunk_frames=4096, max_radius=30)
    assert farm._capacity == staging_capacity(30, 4096, 64)
    (_, _, plan), = farm._launch_specs(256)
    assert plan == (8, 256, False), plan


def test_farm_strided_padding_frames_stay_in_buffer():
    """Exact-stride launches pad their frame count to a multiple of 8, and
    the padding frames' windows start d rows apart past the last legal one;
    at full staging fill (a flush after a full chunk) only those padding
    windows may be clamped into the buffer, never a legal one."""
    rng = np.random.default_rng(59)
    ch, chunk = 2, 509                     # natural counts off the 8 grain
    data = rng.integers(-32768, 32768, size=(3, 2 * chunk, ch)).astype(np.int16)
    farm = UniformStreamFarm(3, ch, 192000, 48000, chunk_frames=chunk)
    (_, _, plan), = farm._launch_specs(chunk // 4)
    assert plan[1] % 8 == 0 and plan[1] > chunk // 4, plan
    outs = [farm.process(data[:, :chunk]), farm.process(data[:, chunk:]),
            farm.flush()]
    got = np.concatenate(outs, axis=1)
    for i in range(3):
        want = _host_reference(data[i], ch, 192000, 48000, 192000)
        np.testing.assert_array_equal(got[i], want, err_msg=f"stream {i}")


def test_farm_launch_routes_by_platform(monkeypatch):
    """The farm plans the same launches for every ratio class on the GPU as
    on the CPU, each at its ratio's tap width; the platform only decides
    where the staging buffer lives."""
    from clownresampler_tpu import platform

    rates = [((48000, 44100), 8), ((44100, 8000), 40), ((44100, 132), 2008),
             ((96000, 48000), 16)]
    plans = {}
    for name in ("cpu", "gpu"):
        monkeypatch.setattr(platform, "backend", lambda: name)
        for (i, o), taps in rates:
            farm = UniformStreamFarm(2, 2, i, o, chunk_frames=256)
            assert farm._device_staging == (name == "gpu")
            specs = farm._launch_specs(64)
            assert {p[0] for _, _, p in specs} == {taps}
            plans.setdefault((i, o), []).append([p for _, _, p in specs])
    assert all(cpu == gpu for cpu, gpu in plans.values())
