"""Unit tests for C-exact fixed-point primitives (clownresampler.h:615-625)."""

import numpy as np
import jax.numpy as jnp
import pytest

from clownresampler_tpu import fixedpoint as fx
from tests import oracle


def c_trunc_div(a: int, b: int) -> int:
    """C integer division: truncation toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def test_trunc_shr_matches_c_division():
    rng = np.random.default_rng(0)
    xs = np.concatenate(
        [
            rng.integers(-(2**31), 2**31, size=5000),
            np.array([0, 1, -1, 65535, -65535, 65536, -65536, 2**31 - 1, -(2**31)]),
        ]
    ).astype(np.int64)
    for bits in (15, 16):
        got = np.asarray(fx.trunc_shr(jnp.asarray(xs, jnp.int32), bits))
        want = np.array([c_trunc_div(int(x), 1 << bits) for x in xs])
        np.testing.assert_array_equal(got, want)


def test_fixed_mul_trunc_extremes():
    # Extreme sample/kernel combos, incl. the int32-min product -32768*65536.
    samples = np.array([-32768, -32767, -1, 0, 1, 32767], np.int64)
    kernels = np.array([-9651, -1, 0, 1, 65535, 65536], np.int64)
    s, k = np.meshgrid(samples, kernels)
    got = np.asarray(
        fx.fixed_mul_trunc(jnp.asarray(s.ravel(), jnp.int32), jnp.asarray(k.ravel(), jnp.int32))
    )
    want = np.array([c_trunc_div(int(a * b), 65536) for a, b in zip(s.ravel(), k.ravel())])
    np.testing.assert_array_equal(got, want)


def test_reciprocal_q31():
    rng = np.random.default_rng(1)
    denoms = np.concatenate(
        [
            rng.integers(2, 2**28, size=2000),
            -rng.integers(2, 2**28, size=100),
            np.array([2, 3, 65535, 65536, 65537, 2**28]),
        ]
    ).astype(np.int64)
    got = np.asarray(fx.reciprocal_q31(jnp.asarray(denoms, jnp.int32)))
    want = np.array([c_trunc_div(0x80000000, int(d)) for d in denoms])
    np.testing.assert_array_equal(got, want)


def test_mul_shift15_against_int64():
    rng = np.random.default_rng(2)
    # acc within the convolution accumulator domain, q within the reciprocal
    # domain for realistic normaliser sums (>= ~2^12).
    acc = np.concatenate(
        [
            rng.integers(-(2**22), 2**22, size=5000),
            np.array([0, 1, -1, 2**21, -(2**21)]),
        ]
    ).astype(np.int64)
    q = np.concatenate(
        [rng.integers(1, 2**19, size=5000), np.array([1, 2, 32768, 39321, 2**19 - 1])]
    ).astype(np.int64)
    got = np.asarray(
        fx.mul_shift15(jnp.asarray(acc, jnp.int32), jnp.asarray(q, jnp.int32))
    )
    want = np.array([c_trunc_div(int(a) * int(b), 1 << 15) for a, b in zip(acc, q)])
    np.testing.assert_array_equal(got, want)


def test_mul_shift15_negative_q():
    got = np.asarray(fx.mul_shift15(jnp.int32(12345), jnp.int32(-6789)))
    assert got == c_trunc_div(12345 * -6789, 1 << 15)


@pytest.mark.parametrize(
    "a,b",
    [
        (44100, 8000),
        (8000, 44100),
        (48000, 44100),
        (44100, 48000),
        (1, 2),
        (2, 1),
        (44100, 44100),
        (0, 5),
        (5, 0),
        (2**31, 1),
        (65536, 1),
        (65535, 1),
        (1, 10**9),
    ],
)
def test_calculate_ratio_semantics(a, b):
    got = fx.calculate_ratio(a, b)
    if a == 0 or b == 0:
        assert got == fx.RATIO_SENTINEL
    else:
        exact = (a << 16) // b
        if exact >= 1 << 32:
            assert got == fx.RATIO_SENTINEL
        elif exact == 0:
            assert got == 1
        else:
            assert got == exact


def test_calculate_ratio_against_oracle():
    for row in oracle.configs():
        a, b = int(row[0]), int(row[1])
        assert fx.calculate_ratio(a, b) == int(row[8]) & 0xFFFFFFFF
        assert fx.calculate_ratio(b, a) == int(row[9]) & 0xFFFFFFFF


def test_positions_from_state():
    rng = np.random.default_rng(3)
    for _ in range(50):
        p0 = int(rng.integers(0, 10000))
        f0 = int(rng.integers(0, 65536))
        inc = int(rng.integers(1, 2**28))
        hi, lo = fx.split_increment(inc)
        n = jnp.arange(1000, dtype=jnp.int32)
        pos, frac = fx.positions_from_state(
            jnp.int32(p0), jnp.int32(f0), jnp.int32(hi), jnp.int32(lo), n
        )
        t = f0 + np.arange(1000, dtype=np.int64) * inc
        np.testing.assert_array_equal(np.asarray(pos), p0 + (t >> 16))
        np.testing.assert_array_equal(np.asarray(frac), t & 0xFFFF)


def test_reciprocal_q31_float_first_edges():
    """The float-first exact-division formulation vs int64 division over the
    realisable domain edges and a dense random sample (the full [2, 2^28]
    domain is swept on the GPU by chip_smoke.py's reciprocal phase)."""
    import numpy as np

    from clownresampler_tpu import fixedpoint as fx

    edges = [2, 3, 4, 5, 7, 2**16 - 1, 2**16, 2**16 + 1, 3 * 2**16,
             2**24 - 1, 2**24, 2**24 + 1, 2**28 - 1, 2**28]
    rng = np.random.default_rng(5)
    m = np.concatenate([
        np.asarray(edges, np.int64),
        rng.integers(2, 1 << 28, 1 << 16).astype(np.int64),
    ])
    for sign in (1, -1):
        denom = (sign * m).astype(np.int32)
        got = np.asarray(fx.reciprocal_q31(jnp.asarray(denom)))
        want = np.where(
            denom < 0,
            -((np.int64(1) << 31) // m),
            (np.int64(1) << 31) // m,
        ).astype(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"sign={sign}")
