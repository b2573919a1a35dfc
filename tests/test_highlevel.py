"""High-level buffered streaming parity: replay the C-oracle scripts.

Covers the staging-buffer geometry (dead-zone halo memmove,
clownresampler.h:1143-1154), leading-padding priming incl. EOF mid-prime
(1127-1136), output-quota-limited resumption, transactional Adjust
(1183-1209) and the ResampleEnd zero-flush (1242-1250), with full state
(cursors, padding counters) compared after every op.
"""

import numpy as np
import pytest

from clownresampler_tpu.highlevel import HighLevelResampler
from tests import oracle


def _replay(name, meta, ops, expected_out, stream):
    ch = meta["channels"]
    in_rate, out_rate, lpf = meta["rates"]
    stream_frames = meta["stream_frames"]
    stream = stream.reshape(-1, ch)

    rs = HighLevelResampler.init(ch, in_rate, out_rate, lpf)
    assert rs is not None

    # Mirror of the C harness input callback: scripted per-invocation caps.
    state = {"cursor": 0, "chunk_i": 0}
    chunk_caps = {
        "hl_stream_up": [100, 50, 1000, 3, 997, 10000, 10000],
        "hl_stream_down": [100, 50, 1000, 3, 997, 10000, 10000],
        "hl_stream_mono": [100, 50, 1000, 3, 997, 10000, 10000],
        "hl_eof_prime": [2, 0, 10000],
    }.get(name, [])

    def input_callback(total_frames: int) -> np.ndarray:
        want = total_frames
        if state["chunk_i"] < len(chunk_caps):
            want = min(want, chunk_caps[state["chunk_i"]])
            state["chunk_i"] += 1
        give = min(want, stream_frames - state["cursor"])
        out = stream[state["cursor"] : state["cursor"] + give]
        state["cursor"] += give
        return out

    collected: list = []
    for row in ops:
        op, a0, a1, a2 = (int(v) for v in row[:4])
        exp = [int(v) for v in row[4:14]]
        before = sum(f.shape[0] for f in collected)

        if op == 1:
            ret = rs.resample(input_callback, output_limit=a0, _collect=collected)
        elif op == 2:
            ret = rs.adjust(a0, a1, a2)
        elif op == 3:
            ret = rs.resample_end(output_limit=a0, _collect=collected)
        else:
            raise AssertionError(f"unknown op {op}")

        produced = sum(f.shape[0] for f in collected) - before
        low = rs.low_level
        got = [
            int(ret),
            produced,
            state["cursor"],
            low.position_integer,
            low.position_fractional,
            low.increment,
            low.config.integer_stretched_kernel_radius,
            rs.leading_padding_frames_needed,
            rs.trailing_padding_frames_remaining,
            rs.buffer_fill_frames(),
        ]
        assert got == exp, (name, row.tolist(), got)

    got_out = (
        np.concatenate(collected, axis=0).ravel()
        if collected
        else np.zeros(0)
    )
    np.testing.assert_array_equal(got_out, expected_out, err_msg=name)


@pytest.mark.parametrize(
    "script", list(oracle.scripts("highlevel")), ids=lambda s: s[0]
)
def test_highlevel_script(script):
    _replay(*script)


@pytest.mark.parametrize("in_rate,out_rate,ch", [
    (48000, 44100, 1),    # near class (the config-1b bench ratio)
    (96000, 48000, 2),    # exact stride d=2
    (44100, 8000, 2),     # general class
])
def test_resample_stream_bulk_fused_identical_bytes(in_rate, out_rate, ch):
    """resample_stream(bulk=True) — the whole stream as ONE fused device
    scan, incl. the ResampleEnd zero-flush — must emit byte-identical output
    to the host chunk loop (VERDICT r2 item 8; the reference's chunk loop
    clownresampler.h:1120-1176 as one device computation)."""
    import numpy as np

    from clownresampler_tpu.highlevel import HighLevelResampler

    rng = np.random.default_rng(83)
    data = rng.integers(-32768, 32768, size=(9000, ch)).astype(np.int16)

    def make_input():
        cursor = 0

        def cb(total_frames: int) -> np.ndarray:
            nonlocal cursor
            give = min(total_frames, 997, data.shape[0] - cursor)
            out = data[cursor : cursor + give]
            cursor += give
            return out

        return cb

    host = HighLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    want = host.resample_stream(make_input(), bulk=False)
    fused = HighLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    got = fused.resample_stream(make_input(), bulk=True)
    np.testing.assert_array_equal(got, want)

    # empty stream: the bulk path defers to the host loop's exact semantics
    empty = HighLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    got_e = empty.resample_stream(lambda n: np.zeros((0, ch), np.int16), bulk=True)
    ref_e = HighLevelResampler.init(ch, in_rate, out_rate, max(in_rate, out_rate))
    want_e = ref_e.resample_stream(lambda n: np.zeros((0, ch), np.int16), bulk=False)
    np.testing.assert_array_equal(got_e, want_e)


def test_resample_stream_bulk_fallbacks_lossless():
    """When the fused bulk path declines (stream past the device budget, or
    a non-pristine resampler), the host loop takes over with every
    already-drained frame replayed — identical bytes, no data loss."""
    import numpy as np

    from clownresampler_tpu.highlevel import HighLevelResampler

    rng = np.random.default_rng(89)
    data = rng.integers(-32768, 32768, size=(6000, 1)).astype(np.int16)

    def make_input():
        cursor = 0

        def cb(total_frames: int) -> np.ndarray:
            nonlocal cursor
            give = min(total_frames, 613, data.shape[0] - cursor)
            out = data[cursor : cursor + give]
            cursor += give
            return out

        return cb

    ref = HighLevelResampler.init(1, 48000, 44100, 44100)
    want = ref.resample_stream(make_input(), bulk=False)

    # force the device-budget overflow mid-drain: frames already pulled from
    # the callback must be replayed into the host loop
    tiny = HighLevelResampler.init(1, 48000, 44100, 44100)
    tiny.BULK_MAX_DEVICE_BYTES = 1 << 14      # ~1.4k-frame cap
    got = tiny.resample_stream(make_input(), bulk=True)
    np.testing.assert_array_equal(got, want)

    # non-pristine resampler: bulk=True quietly uses the host loop
    busy = HighLevelResampler.init(1, 48000, 44100, 44100)
    inp = make_input()
    busy.resample(inp, output_limit=37)       # primes + buffers state
    rest_bulk = busy.resample_stream(inp, bulk=True)
    busy2 = HighLevelResampler.init(1, 48000, 44100, 44100)
    inp2 = make_input()
    busy2.resample(inp2, output_limit=37)
    rest_host = busy2.resample_stream(inp2, bulk=False)
    np.testing.assert_array_equal(rest_bulk, rest_host)


def test_realtime_refusal_resumes_bit_exact():
    """End-to-end output-refusal drive (VERDICT r1 item 7): a simulated audio
    device fills fixed periods, the output callback refuses when each period's
    buffer is full (clownresampler.h:83-125, 301-343), and the resumed stream
    must equal the unrefused stream bit-for-bit, including the ResampleEnd
    tail flushed through the same refusing callback."""
    import numpy as np

    from clownresampler_tpu.highlevel import HighLevelResampler

    rng = np.random.default_rng(77)
    data = rng.integers(-32768, 32768, size=(5000, 2)).astype(np.int16)

    def make_input():
        cursor = 0

        def cb(total_frames: int) -> np.ndarray:
            nonlocal cursor
            give = min(total_frames, 777, data.shape[0] - cursor)
            out = data[cursor : cursor + give]
            cursor += give
            return out

        return cb

    # Reference: one uninterrupted stream (resample + flush).
    ref = HighLevelResampler.init(2, 44100, 32000, 32000)
    want = ref.resample_stream(make_input())

    # Device loop: 256-frame periods, refusal on every period boundary.
    rs = HighLevelResampler.init(2, 44100, 32000, 32000)
    inp = make_input()
    periods = []
    input_exhausted = False
    flushed = False
    while not flushed:
        buf = np.empty((256, 2), np.int32)
        written = 0

        def out_cb(frame):
            nonlocal written
            buf[written] = frame
            written += 1
            return written < buf.shape[0]

        if not input_exhausted:
            input_exhausted = rs.resample(inp, out_cb)
        if input_exhausted and written < buf.shape[0]:
            flushed = rs.resample_end(out_cb)
        periods.append(buf[:written].copy())
    got = np.concatenate(periods, axis=0)

    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_rate,out_rate,ch,n_a", [
    (48000, 44100, 2, 5000),   # near class
    (44100, 8000, 2, 3000),    # general class, radius 17
    (44100, 8000, 1, 10),      # stream shorter than the kernel radius
])
def test_bulk_then_incremental_resume(in_rate, out_rate, ch, n_a):
    """VERDICT r3 item 6: after resample_stream(bulk=True) the object must be
    in the C-EXACT post-flush state (clownresampler.h:650-659, 1242-1250), so
    resuming incremental streaming on it stays byte-identical to a host-loop
    object that streamed + flushed + resumed the same way."""
    rng = np.random.default_rng(101)
    a = rng.integers(-32768, 32768, size=(n_a, ch)).astype(np.int16)
    b = rng.integers(-32768, 32768, size=(4000, ch)).astype(np.int16)

    def make_cb(data, cap=991):
        cursor = 0

        def cb(total_frames: int) -> np.ndarray:
            nonlocal cursor
            give = min(total_frames, cap, data.shape[0] - cursor)
            out = data[cursor : cursor + give]
            cursor += give
            return out

        return cb

    lpf = max(in_rate, out_rate)
    bulk = HighLevelResampler.init(ch, in_rate, out_rate, lpf)
    host = HighLevelResampler.init(ch, in_rate, out_rate, lpf)
    out_b1 = bulk.resample_stream(make_cb(a), bulk=True)
    out_h1 = host.resample_stream(make_cb(a), bulk=False)
    np.testing.assert_array_equal(out_b1, out_h1)

    # Full post-flush state equality (the resumed loop reads nothing beyond
    # the 2*radius halo before overwriting it, so that is the state surface).
    r2ch = 2 * host.maximum_integer_stretched_kernel_radius * ch
    assert (bulk.low_level.position_integer, bulk.low_level.position_fractional) \
        == (host.low_level.position_integer, host.low_level.position_fractional)
    assert (bulk.input_buffer_start, bulk.input_buffer_end) \
        == (host.input_buffer_start, host.input_buffer_end)
    assert bulk.leading_padding_frames_needed == host.leading_padding_frames_needed == 0
    assert bulk.trailing_padding_frames_remaining \
        == host.trailing_padding_frames_remaining == 0
    np.testing.assert_array_equal(bulk.input_buffer[:r2ch], host.input_buffer[:r2ch])

    # Resume incremental streaming on both objects: same ops, same bytes.
    for rs_obj, outs in ((bulk, []), (host, [])):
        cb = make_cb(b, cap=613)
        rs_obj.resample(cb, _collect=outs)
        rs_obj.resample_end(_collect=outs)
        if rs_obj is bulk:
            got2 = np.concatenate(outs, axis=0) if outs else np.zeros((0, ch), np.int32)
        else:
            want2 = np.concatenate(outs, axis=0) if outs else np.zeros((0, ch), np.int32)
    np.testing.assert_array_equal(got2, want2)
    assert got2.shape[0] > 0
