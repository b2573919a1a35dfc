"""Low-level streaming parity: replay the C-oracle scripts step by step.

Each script drives ClownResampler_LowLevel_* in the C harness
(tools/gen_oracle_vectors.c) and records outputs, return values, consumed
counts and full state after every op. Replaying through LowLevelResampler must
match everything bit-for-bit: chunked feeds with position carry
(clownresampler.h:1063-1068), output-full rewind (1084-1088), mid-stream
Adjust pitch bends (1052-1056), integer ratios and unity passthrough.
"""

import numpy as np
import pytest

from clownresampler_tpu.lowlevel import LowLevelResampler
from tests import oracle


def _replay(name, meta, ops, expected_out, stream):
    ch = meta["channels"]
    in_rate, out_rate, lpf = meta["rates"]
    pad = meta["pad"]
    stream_frames = meta["stream_frames"]
    stream = stream.reshape(-1, ch)

    rs = LowLevelResampler.init(ch, in_rate, out_rate, lpf)
    assert rs is not None

    produced_frames = []
    cursor = 0
    for row in ops:
        op, a0, a1, a2 = (int(v) for v in row[:4])
        exp_ret, exp_remaining, exp_produced = (int(v) for v in row[4:7])
        exp_state = tuple(int(v) for v in row[7:14])

        if op == 1:
            n = min(a0, stream_frames - cursor)
            radius = rs.config.integer_stretched_kernel_radius
            start = pad + cursor - radius
            window = stream[start : pad + cursor + n + radius]
            ret, remaining, frames = rs.resample(window, n, output_limit=a1)
            assert ret == bool(exp_ret), (name, row)
            assert remaining == exp_remaining, (name, row)
            assert frames.shape[0] == exp_produced, (name, row)
            produced_frames.append(frames)
            cursor += n - remaining
        elif op == 2:
            ret = rs.adjust(a0, a1, a2)
            assert ret == bool(exp_ret), (name, row)
        else:
            raise AssertionError(f"unknown op {op}")

        assert rs.state_tuple() == exp_state, (name, row)

    got = np.concatenate(produced_frames, axis=0).ravel() if produced_frames else np.zeros(0)
    np.testing.assert_array_equal(got, expected_out, err_msg=name)


@pytest.mark.parametrize(
    "script", list(oracle.scripts("lowlevel")), ids=lambda s: s[0]
)
def test_lowlevel_script(script):
    _replay(*script)


def _oracle(padded, n_in, in_rate, out_rate, lpf=None):
    return oracle.convolve_padded(padded, n_in, in_rate, out_rate,
                                  lpf or max(in_rate, out_rate))


def _stream(rng, n_in, ch, r):
    data = rng.integers(-32768, 32768, size=(n_in, ch)).astype(np.int16)
    padded = np.zeros((n_in + 2 * r, ch), np.int16)
    padded[r : r + n_in] = data
    return padded


@pytest.mark.parametrize("in_rate,out_rate,ch,n_in", [
    (48000, 44100, 2, 2600),    # near class
    (96000, 48000, 1, 5200),    # exact stride d=2
    (44100, 8000, 2, 14000),    # general class
])
def test_batched_tile_dispatch_bit_exact(monkeypatch, in_rate, out_rate, ch, n_in):
    """The grouped multi-tile device dispatch (all windows uploaded first,
    TILE_LAUNCH_GROUP independent launches fused per program, downloads
    last) must be bit-equal to the oracle. MAX_CHUNK_OUTPUT_FRAMES is shrunk
    so a moderate stream spans many tiles, exercising the grouping, the
    tail-tile shape change, and the device-side int16->int32 widening."""
    from clownresampler_tpu import lowlevel

    monkeypatch.setattr(lowlevel, "MAX_CHUNK_OUTPUT_FRAMES", 512)
    rs = LowLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    padded = _stream(np.random.default_rng(101), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert got.shape[0] > 512, "stream too short to exercise multiple tiles"
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_batched_tile_dispatch_wide_kernel(monkeypatch):
    """Wide kernels (taps 2008) through the same batched dispatch: tiles
    bounded by the lanes route's window-gather bound, several grouped per
    program, bit-equal to the oracle."""
    from clownresampler_tpu.ops import resample as ops

    monkeypatch.setattr(ops, "WINDOW_GATHER_BYTES", 64 * 2008 * 4)
    in_rate, out_rate, ch = 44100, 132, 1      # radius 1003, taps 2008
    n_in = 60000                                # ~180 output frames, 3 tiles
    rs = LowLevelResampler.init(ch, in_rate, out_rate, in_rate)
    assert rs._max_taps == 2008
    padded = _stream(np.random.default_rng(103), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert got.shape[0] >= 128
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_wide_serves_lane_aware_crossover():
    """Tiles launch at the current ratio's tap width, for every ratio class
    and lane count (no lane padding)."""
    from clownresampler_tpu import lowlevel

    seen = []
    real = lowlevel._grouped_packed_launch

    def spy(table, xs, f0s, cfg, plans):
        seen.extend((p[0], x.shape[1]) for p, x in zip(plans, xs))
        return real(table, xs, f0s, cfg, plans)

    lowlevel._grouped_packed_launch, saved = spy, real
    try:
        for (i, o), ch, want in [((48000, 44100), 3, (8,)),
                                 ((96000, 48000), 1, (16,)),
                                 ((44100, 8000), 130, (40,))]:
            seen.clear()
            rs = LowLevelResampler.init(ch, i, o, max(i, o), max_radius=30)
            rs.resample(np.zeros((600, ch), np.int16), 500)
            assert seen and set(seen) == {want + (ch,)}, seen
    finally:
        lowlevel._grouped_packed_launch = saved


@pytest.mark.parametrize("in_rate,out_rate", [
    (44100, 349),   # taps 760
    (44100, 991),   # taps 272
])
def test_medium_width_wide_dispatch_bit_exact(in_rate, out_rate):
    """Medium tap widths through the lanes route and the batched dispatch
    stay bit-equal to the oracle."""
    ch, n_in = 2, 30000
    rs = LowLevelResampler.init(ch, in_rate, out_rate, in_rate)
    assert 248 < rs._max_taps <= 1024
    padded = _stream(np.random.default_rng(107), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert got.shape[0] >= 128
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_pack_super_groups_shapes():
    """The cycle packer's unit contract: same-shape runs become
    TILE_LAUNCH_GROUP-capped groups; cycles split exactly when the next
    group's resident+transient footprint exceeds the budget, carrying the
    PREVIOUS groups' resident arrays (windows+outputs) but not their
    transients."""
    from clownresampler_tpu.lowlevel import TILE_LAUNCH_GROUP, _pack_super_groups

    # (tile, n_pad, rows, p0, f0): packing keys on n_pad/rows only
    mk = lambda n_pad, rows: (n_pad, n_pad, rows, 0, 0)
    for ch in (2, 130):
        res = lambda n_pad, rows: rows * ch * 2 + n_pad * ch * 4
        tmp = lambda n_pad, rows: rows * ch * 4     # the widened int32 window

        # 6 same-shape tiles -> groups of 4 + 2; a shape change breaks a run
        descs = [mk(512, 1024)] * 6 + [mk(256, 1024)]
        sg = _pack_super_groups(descs, ch, 10 << 30)
        assert TILE_LAUNCH_GROUP == 4
        assert sg == [[(0, 4), (4, 6), (6, 7)]]   # one cycle, 3 groups

        # budget tuned so the FIRST cycle holds exactly two groups, then
        # splits: after groups 1+2 are resident, group 3's check is
        # resident(g1+g2) + res(g3) + tmp(g3) > budget.
        budget = 2 * 4 * res(512, 1024) + 4 * tmp(512, 1024)
        descs = [mk(512, 1024)] * 12
        assert _pack_super_groups(descs, ch, budget) == [
            [(0, 4), (4, 8)], [(8, 12)]]
        # one byte less tips the second group out
        assert _pack_super_groups(descs, ch, budget - 1) == [
            [(0, 4)], [(4, 8)], [(8, 12)]]
        # a budget below one group still yields one group per cycle
        assert _pack_super_groups(descs, ch, 1) == [[(0, 4)], [(4, 8)], [(8, 12)]]


def test_sequential_wide_tile_many_channels():
    """A single-tile stream (<= 64 wide output frames) at channels > 128:
    the window keeps the stream's own lane count."""
    in_rate, out_rate, ch = 44100, 132, 130    # radius 1003, taps 2008
    n_in = 12000                               # ~35 output frames: ONE tile
    rs = LowLevelResampler.init(ch, in_rate, out_rate, in_rate)
    padded = _stream(np.random.default_rng(109), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert 0 < got.shape[0] <= 64, "stream must stay a single wide tile"
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_batched_tile_dispatch_super_groups(monkeypatch):
    """Streams past BATCH_DEVICE_BUDGET_BYTES split into several sequential
    upload->launch->download cycles (bounded device residency for direct
    resample() calls of any length); the cycle boundaries — including a
    cycle holding SEVERAL groups followed by a split, which exercises the
    windows[i-lo:j-lo] cycle-relative slicing — must not change a byte vs
    the oracle."""
    from clownresampler_tpu import lowlevel
    from clownresampler_tpu.lowlevel import _pack_super_groups

    monkeypatch.setattr(lowlevel, "MAX_CHUNK_OUTPUT_FRAMES", 512)
    in_rate, out_rate, ch, n_in = 48000, 44100, 2, 7000
    # Capture the descs the dispatch actually builds, then pick a budget that
    # provably packs them as >=2 cycles with some cycle holding >=2 groups
    # (a fixed byte count would silently stop exercising the multi-group
    # cycle whenever the geometry formulas move).
    captured = {}
    orig = lowlevel._pack_super_groups

    def spy(descs, ch_, budget):
        captured["descs"] = descs
        return orig(descs, ch_, budget)

    monkeypatch.setattr(lowlevel, "_pack_super_groups", spy)
    rs = LowLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    padded = _stream(np.random.default_rng(107), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    rs.resample(padded, n_in)
    descs = captured["descs"]
    budget = None
    for cand_budget in range(1 << 12, 64 << 20, 1 << 12):
        sg = _pack_super_groups(descs, ch, cand_budget)
        if len(sg) >= 2 and any(len(cycle) >= 2 for cycle in sg):
            budget = cand_budget
            break
    assert budget is not None, "no budget packs >=2 cycles with a multi-group cycle"

    fast = LowLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    fast.BATCH_DEVICE_BUDGET_BYTES = budget
    _, _, got = fast.resample(padded, n_in)
    assert got.shape[0] > 1024, "stream too short to span several cycles"
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_multilane_general_dispatch_bit_exact():
    """channels > 128 through the general class: lanes are the stream's own
    channels, bit-equal to the oracle over several tiles."""
    ch, n_in = 136, 26000            # ~4.7k output frames
    in_rate, out_rate = 44100, 8000  # general class (d=5, frac != 0)
    rs = LowLevelResampler.init(ch, in_rate, out_rate, 44100)
    padded = _stream(np.random.default_rng(211), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert got.shape[0] > 2200, "stream too short to exercise multiple tiles"
    np.testing.assert_array_equal(got, _oracle(padded, n_in, in_rate, out_rate))


def test_small_chunk_micro_launch_dispatch_bit_exact(monkeypatch):
    """A ~110-frame stream is ONE launch padded to the 64-frame grain (128
    frames), and stays bit-exact."""
    from clownresampler_tpu import lowlevel

    plans = []
    real = lowlevel._grouped_packed_launch

    def spy(table, xs, f0s, cfg, p):
        plans.extend(p)
        return real(table, xs, f0s, cfg, p)

    monkeypatch.setattr(lowlevel, "_grouped_packed_launch", spy)
    ch, n_in = 2, 120
    rs = LowLevelResampler.init(ch, 48000, 44100, 48000)
    padded = _stream(np.random.default_rng(307), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert [p[1] for p in plans] == [128], plans
    np.testing.assert_array_equal(got, _oracle(padded, n_in, 48000, 44100))


def test_wide_reserve_narrow_ratio_fast_kernel_dispatch(monkeypatch):
    """A stream whose RESERVE is wide (taps 2008) but whose current ratio is
    narrow launches at the current width (40 taps), bit-exact vs the
    oracle."""
    from clownresampler_tpu import lowlevel

    plans = []
    real = lowlevel._grouped_packed_launch

    def spy(table, xs, f0s, cfg, p):
        plans.extend(p)
        return real(table, xs, f0s, cfg, p)

    monkeypatch.setattr(lowlevel, "_grouped_packed_launch", spy)
    ch, n_in = 2, 9000
    rs = LowLevelResampler.init(ch, 44100, 8000, 44100, max_radius=1003)
    assert rs._max_taps == 2008
    padded = _stream(np.random.default_rng(113), n_in, ch,
                     rs.config.integer_stretched_kernel_radius)
    _, _, got = rs.resample(padded, n_in)
    assert plans and all(p[0] == 40 for p in plans), plans
    np.testing.assert_array_equal(got, _oracle(padded, n_in, 44100, 8000))
