"""On-device scan pipeline: one jitted scan == the host streaming path."""

import jax.numpy as jnp
import numpy as np
import pytest

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu.configure import configure
from clownresampler_tpu.lowlevel import (
    LowLevelResampler,
    make_device_state,
    resample_scan,
    resample_scan_fused,
)
from clownresampler_tpu.models import lanczos_kernel_table


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (8000, 44100), (44100, 8000)])
def test_scan_matches_host(in_rate, out_rate):
    rng = np.random.default_rng(31)
    lanes, n_in, k = 4, 128, 6
    lpf = max(in_rate, out_rate)
    cfg = configure(in_rate, out_rate, lpf)
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    # per-step cap: steady n_in frames of input plus the initial
    # radius-bias backlog that can spill into any one step
    n_out_cap = ((n_in + 2 * r) * 65536) // inc + 16

    data = rng.integers(-32768, 32768, size=(k * n_in, lanes)).astype(np.int16)
    chunks = jnp.asarray(data.reshape(k, n_in, lanes))
    # Flush: one extra all-zero chunk drains at least the radius tail.
    chunks = jnp.concatenate([chunks, jnp.zeros((1, n_in, lanes), jnp.int16)])

    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0, cfg, inc)
    outputs, produced, _, backlog = resample_scan(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r
    )
    assert not bool(backlog)
    outputs = np.asarray(outputs)
    produced = np.asarray(produced)
    got = np.concatenate(
        [outputs[i, : produced[i]] for i in range(k + 1)], axis=0
    )

    # Host reference over the whole stream + the same zero-chunk tail.
    rs = LowLevelResampler.init(lanes, in_rate, out_rate, lpf)
    full = np.concatenate([data, np.zeros((n_in, lanes), np.int16)])
    padded = np.concatenate(
        [np.zeros((r, lanes), np.int16), full, np.zeros((r, lanes), np.int16)]
    )
    _, _, want = rs.resample(padded, full.shape[0])

    np.testing.assert_array_equal(got, want[: got.shape[0]], err_msg=str((in_rate, out_rate)))
    # The scan drains everything except up to `radius` input frames of the
    # zero-flush tail (the position bias holds them back); those frames are
    # all-zero windows, i.e. trailing silence.
    tol = (r * 65536) // inc + 3
    assert got.shape[0] >= want.shape[0] - tol, (got.shape, want.shape)
    assert not want[got.shape[0] :].any(), "undrained frames must be silence"


FUSED_RATIOS = [
    (48000, 44100),   # near class (sub-2x)
    (44100, 48000),   # near class upsample
    (96000, 48000),   # exact stride d=2
    (192000, 48000),  # exact stride d=4
    (44100, 8000),    # general (d=5, lo != 0) — the wide-downsample golden ratio
    (40000, 11025),   # general d=3
]


@pytest.mark.parametrize("in_rate,out_rate", FUSED_RATIOS)
def test_scan_fused_matches_oracle_scan(in_rate, out_rate):
    """The fused scan == the oracle scan for every ratio class, chunk for
    chunk (whole-stream streaming for ANY ratio, clownresampler.h:1138-1173
    as one device computation)."""
    rng = np.random.default_rng(55)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    lanes, n_in, k = 128, 256, 5
    n_out_cap = -(-(((n_in + 2 * r) * 65536) // inc + 16) // 128) * 128

    data = rng.integers(-32768, 32768, size=(k, n_in, lanes)).astype(np.int32)
    chunks = jnp.asarray(data)
    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0, cfg, inc)

    ref_out, ref_prod, ref_state, ref_back = resample_scan(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r
    )
    got_out, got_prod, got_state, got_back = resample_scan_fused(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r,
    )
    assert not bool(ref_back) and not bool(got_back)
    np.testing.assert_array_equal(np.asarray(got_prod), np.asarray(ref_prod))
    np.testing.assert_array_equal(np.asarray(got_out), np.asarray(ref_out))
    assert int(got_state.position_integer) == int(ref_state.position_integer)
    assert int(got_state.position_fractional) == int(ref_state.position_fractional)


@pytest.mark.parametrize("in_rate,out_rate,lanes", [
    (44100, 132, 8),      # radius 1003, taps 2008: the widest class streams too
    (48000, 44100, 3),    # odd lane count: no lane padding
])
def test_scan_fused_wide_and_odd_lanes_match_oracle_scan(in_rate, out_rate, lanes):
    """The fused scan serves every tap width and lane count through the
    lanes route, chunk for chunk equal to the oracle scan."""
    rng = np.random.default_rng(58)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    n_in, k = 2048, 3
    n_out_cap = -(-(((n_in + 2 * r) * 65536) // inc + 16) // 8) * 8
    chunks = jnp.asarray(
        rng.integers(-32768, 32768, size=(k, n_in, lanes)).astype(np.int16))
    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0x1357, cfg, inc)
    ref = resample_scan(table, chunks, state, max_taps=max_taps,
                        n_out=int(n_out_cap), radius=r)
    got = resample_scan_fused(table, chunks, state, max_taps=max_taps,
                              n_out=int(n_out_cap), radius=r)
    assert not bool(ref[3]) and not bool(got[3])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_scan_backlog_flag_on_undersized_n_out():
    """Advisor regression: an undersized static n_out must raise the backlog
    flag instead of silently producing wrong output."""
    rng = np.random.default_rng(57)
    in_rate, out_rate = 8000, 44100          # ~5.5 output frames per input
    cfg = configure(in_rate, out_rate, out_rate)
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    lanes, n_in, k = 4, 128, 4

    chunks = jnp.asarray(
        rng.integers(-32768, 32768, size=(k, n_in, lanes)).astype(np.int16)
    )
    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0, cfg, inc)

    # Proper cap -> no backlog; half of it -> backlog raised.
    good_cap = ((n_in + 2 * r) * 65536) // inc + 16
    *_, ok = resample_scan(
        table, chunks, state, max_taps=8, n_out=int(good_cap), radius=r
    )
    assert not bool(ok)
    *_, bad = resample_scan(
        table, chunks, state, max_taps=8, n_out=int(good_cap) // 2, radius=r
    )
    assert bool(bad)


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (96000, 48000),
                                              (44100, 8000)])
@pytest.mark.parametrize("split", [2, 4])
def test_scan_fused_split_chains_bit_exact(in_rate, out_rate, split):
    """split-chain fused scans (independent sub-fleet carries inside one
    scan) == the monolithic fused scan, for every ratio class."""
    rng = np.random.default_rng(61)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    lanes, n_in, k = 128 * split, 256, 4
    n_out_cap = -(-(((n_in + 2 * r) * 65536) // inc + 16) // 128) * 128
    chunks = jnp.asarray(
        rng.integers(-32768, 32768, size=(k, n_in, lanes)).astype(np.int32))
    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0, cfg, inc)

    mono = resample_scan_fused(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r)
    multi = resample_scan_fused(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r,
        split=split)
    np.testing.assert_array_equal(np.asarray(multi[0]), np.asarray(mono[0]))
    np.testing.assert_array_equal(np.asarray(multi[1]), np.asarray(mono[1]))
    assert int(multi[2].position_integer) == int(mono[2].position_integer)
    assert int(multi[2].position_fractional) == int(mono[2].position_fractional)
    assert bool(multi[3]) == bool(mono[3])


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (96000, 48000),
                                              (44100, 8000)])
@pytest.mark.parametrize("split", [1, 4])
def test_scan_fused_pipeline_bit_exact(in_rate, out_rate, split):
    """pipeline=True (double-buffered staging: step t's engine reads the
    buffer staged at t-1 while step t stages chunk t+1) must be
    bit-identical to the serial stage->engine scan for every ratio class,
    split, outputs, produced counts, and state."""
    rng = np.random.default_rng(61)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    lanes, n_in, k = 128 * split, 256, 4
    n_out_cap = -(-(((n_in + 2 * r) * 65536) // inc + 16) // 128) * 128
    chunks = jnp.asarray(
        rng.integers(-32768, 32768, size=(k, n_in, lanes)).astype(np.int16))
    table = jnp.asarray(lanczos_kernel_table())
    state = make_device_state(0, 0x2345, cfg, inc)

    serial = resample_scan_fused(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r,
        split=split, pipeline=False)
    piped = resample_scan_fused(
        table, chunks, state, max_taps=max_taps, n_out=int(n_out_cap), radius=r,
        split=split, pipeline=True)
    np.testing.assert_array_equal(np.asarray(piped[0]), np.asarray(serial[0]))
    np.testing.assert_array_equal(np.asarray(piped[1]), np.asarray(serial[1]))
    assert int(piped[2].position_integer) == int(serial[2].position_integer)
    assert int(piped[2].position_fractional) == int(serial[2].position_fractional)
    assert bool(piped[3]) == bool(serial[3])
