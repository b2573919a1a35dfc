"""Native staging engine: differential tests vs the numpy reference."""

import numpy as np
import pytest

from clownresampler_tpu.utils import native


@pytest.fixture(scope="module")
def have_native():
    if not native.available():
        pytest.skip("native toolchain unavailable; numpy fallback in use")
    return True


def test_stage_chunk(have_native):
    rng = np.random.default_rng(0)
    b, n, c, ld = 7, 13, 2, 7 * 2 + 3
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)
    staging = np.zeros((40, ld), np.int32)
    native.stage_chunk(chunk, staging, row_off=5)
    want = np.zeros_like(staging)
    want[5 : 5 + n, : b * c] = chunk.transpose(1, 0, 2).reshape(n, b * c)
    np.testing.assert_array_equal(staging, want)


def test_shift_and_zero(have_native):
    rng = np.random.default_rng(1)
    staging = rng.integers(-(2**31), 2**31 - 1, size=(32, 16)).astype(np.int32)
    want = staging.copy()
    want[:20] = staging[9:29]
    native.shift_rows(staging, 20, 9)
    np.testing.assert_array_equal(staging[:20], want[:20])
    native.zero_rows(staging, 3, 4)
    assert not staging[3:7].any()


def test_unstage(have_native):
    rng = np.random.default_rng(2)
    b, m, c = 5, 11, 2
    lanes = rng.integers(-(2**31), 2**31 - 1, size=(m, b * c + 6)).astype(np.int32)
    out = native.unstage_output(lanes, b, c)
    want = lanes[:, : b * c].reshape(m, b, c).transpose(1, 0, 2)
    np.testing.assert_array_equal(out, want)


def test_roundtrip(have_native):
    rng = np.random.default_rng(3)
    b, n, c = 16, 64, 2
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)
    staging = np.zeros((n, b * c), np.int32)
    native.stage_chunk(chunk, staging, 0)
    back = native.unstage_output(staging, b, c)
    np.testing.assert_array_equal(back, chunk.astype(np.int32))


def test_numpy_fallback_matches_native():
    """Force the numpy fallback and compare against the C implementation
    (or inline expectations when no toolchain) — incl. padded lanes."""
    import contextlib

    @contextlib.contextmanager
    def forced_fallback():
        lib, tried = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            yield
        finally:
            native._lib, native._tried = lib, tried

    rng = np.random.default_rng(4)
    b, n, c, lanes = 7, 13, 2, 128  # padded lanes: b*c=14 << 128
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)

    stag_a = np.zeros((40, lanes), np.int32)
    with forced_fallback():
        native.stage_chunk(chunk, stag_a, 5)
        native.shift_rows(stag_a, 30, 3)
        native.zero_rows(stag_a, 2, 4)
        out_a = native.unstage_output(stag_a[:9], b, c)

    stag_b = np.zeros((40, lanes), np.int32)
    native.stage_chunk(chunk, stag_b, 5)
    native.shift_rows(stag_b, 30, 3)
    native.zero_rows(stag_b, 2, 4)
    out_b = native.unstage_output(stag_b[:9], b, c)

    np.testing.assert_array_equal(stag_a, stag_b)
    np.testing.assert_array_equal(out_a, out_b)


def test_farm_works_with_numpy_fallback():
    """The farm must function without the C++ toolchain (padded lanes)."""
    import contextlib
    from clownresampler_tpu.farm import UniformStreamFarm
    from tests.test_farm import _host_reference

    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        rng = np.random.default_rng(6)
        data = rng.integers(-32768, 32768, size=(3, 300, 2)).astype(np.int16)
        farm = UniformStreamFarm(3, 2, 48000, 44100, chunk_frames=256)
        outs = [farm.process(data[:, :256]), farm.process(data[:, 256:]), farm.flush()]
        got = np.concatenate(outs, axis=1)
        for i in range(3):
            want = _host_reference(data[i], 2, 48000, 44100, 48000)
            np.testing.assert_array_equal(got[i], want)
    finally:
        native._lib, native._tried = lib, tried
