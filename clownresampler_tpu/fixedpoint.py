"""16.16 fixed-point arithmetic with C-exact semantics, int32-only on device.

The reference library (clownresampler.h:615-625) works in 16.16 fixed point
with C integer division, which truncates toward zero — unlike jnp's ``//``
which floors. Everything here reproduces the C results bit-exactly while using
only int32 device arithmetic, so the kernels never need x64 mode or emulated
int64 (device vector lanes are 32-bit; int64 ops lower to multi-op
sequences).

Host-side bookkeeping (stream positions, frame counts) uses arbitrary-precision
Python ints instead, so it can never overflow regardless of stream length.

Domain notes (see SURVEY.md section 7 for the derivation):
  * tap product ``sample * kernel`` spans [-2^31, 2^31) -> fits int32 exactly.
  * tap accumulator magnitude < taps * 32768 < 2^30 for every legal config
    (taps <= 2 * integer_stretched_kernel_radius <= 2 * 3 * 0x1000).
  * the final normalisation multiply needs ~36 bits -> ``mul_shift15`` does it
    in int32 limbs.
"""

from __future__ import annotations

import jax.numpy as jnp

def round_up(x: int, m: int) -> int:
    """Smallest multiple of m >= x (shared alignment helper)."""
    return -(-x // m) * m


# 16.16 layout (clownresampler.h:620).
FRACTIONAL_BITS = 16
FRACTIONAL_SIZE = 1 << FRACTIONAL_BITS
FRACTIONAL_MASK = FRACTIONAL_SIZE - 1

# Sentinel returned by the ratio computation for zero rates or overflow
# (clownresampler.h:919-920, 938-940).
RATIO_SENTINEL = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host (Python int, exact, unbounded) versions
# ---------------------------------------------------------------------------

def calculate_ratio(a: int, b: int) -> int:
    """floor(a * 65536 / b) with the reference's sentinel/saturation rules.

    Mirrors ClownResampler_CalculateRatio (clownresampler.h:913-953), which
    performs the same computation by 3-limb long division to avoid 64-bit
    intermediates. Python ints are exact, so the closed form is equivalent
    (equivalence verified against the C oracle in tests/test_configure.py).
    """
    if a == 0 or b == 0:
        return RATIO_SENTINEL
    result = (a << FRACTIONAL_BITS) // b
    if result >= 1 << 32:
        return RATIO_SENTINEL
    if result == 0:
        return 1  # underflow clamps to the smallest increment (948-950)
    return result


def to_fixed(x: int) -> int:
    return x << FRACTIONAL_BITS


def fixed_floor(x: int) -> int:
    """Only valid for x >= 0 (the reference applies it to unsigned values)."""
    return x >> FRACTIONAL_BITS


def fixed_ceil(x: int) -> int:
    return (x + FRACTIONAL_MASK) >> FRACTIONAL_BITS


def fixed_round(x: int) -> int:
    return (x + FRACTIONAL_SIZE // 2) >> FRACTIONAL_BITS


# ---------------------------------------------------------------------------
# Device (jnp int32) versions
# ---------------------------------------------------------------------------

def trunc_shr(x, bits: int):
    """C-style ``x / (1 << bits)`` for signed int32: truncation toward zero.

    jnp's ``>>`` is an arithmetic shift (floor); C integer division truncates.
    For negative x the two differ by one whenever the low bits are nonzero.
    Adding ``(1 << bits) - 1`` to negative values fixes that up without
    overflow (x < 0 so the sum stays inside int32).
    """
    mask = (1 << bits) - 1
    bias = jnp.where(x < 0, jnp.int32(mask), jnp.int32(0))
    return (x + bias) >> bits


def fixed_mul_trunc(a, b):
    """C ``(a * b) / 65536`` for int32 values whose product fits in int32.

    This is CLOWNRESAMPLER_FIXED_POINT_MULTIPLY (clownresampler.h:625) as used
    in the convolution hot loop (1020): a is a sign-extended s16 sample, b a
    kernel table value in [-9651, 65536], so the product spans exactly
    [-2^31, 2^31) and int32 multiplication is exact.
    """
    return trunc_shr(a * b, FRACTIONAL_BITS)


def floor_shr16_nonneg(x):
    """``x >> 16`` for values known non-negative (floor == trunc)."""
    return x >> FRACTIONAL_BITS


def ceil_shr16_nonneg(x):
    """C CEILING macro (clownresampler.h:624) for non-negative int32."""
    return (x + FRACTIONAL_MASK) >> FRACTIONAL_BITS


def reciprocal_q31(denom):
    """C ``0x80000000 / denom`` (clownresampler.h:1025) in int32 arithmetic.

    Requires |denom| >= 2 so the quotient fits int32; every realisable kernel
    window sum satisfies this (it is ~65536 * kernel_scale).

    The exact quotient is built float-first: a float32 estimate, two Newton
    residual corrections, then a +-3 integer cleanup. Exactness argument:
    the estimate's absolute error is err <= q*2^-22 + 1 (q <= 2^30, so up
    to 257 in the small-m extreme); the residual r = 2^31 - q*m is computed
    EXACTLY in wraparound int32 because |r_true| <= err*m <= (q*m)*2^-22 + m
    <= 2^31*2^-22 + m = 512 + m < 2^31 for every m < 2^31 - 512 (the error
    term scales as q*2^-22 while m scales inversely with q, so their product
    stays bounded by ~2^9); each correction divides the error by ~2^22, and
    the final where-steps absorb the last +-3 even if the hardware's f32
    divide is a couple of ulps off correctly-rounded.
    Verified exhaustively over m in [2, 2^28] against integer division on
    the GPU (chip_smoke.py, phase "reciprocal"; its time against plain
    division is in PERF.md) and against int64 division in
    tests/test_fixedpoint.py.
    """
    m = jnp.abs(denom)
    m_safe = jnp.maximum(m, 2)  # avoid div-by-zero traps; C would UB anyway
    mf = m_safe.astype(jnp.float32)
    q = (jnp.float32(2.0 ** 31) / mf).astype(jnp.int32)
    r = jnp.int32(-(2 ** 31)) - q * m_safe      # 2^31 - q*m, exact mod 2^32
    for _ in range(2):                          # Newton residual corrections
        dq = (r.astype(jnp.float32) / mf).astype(jnp.int32)
        q = q + dq
        r = r - dq * m_safe
    for _ in range(3):                          # final exact cleanup
        q = jnp.where(r < 0, q - 1, q)
        r = jnp.where(r < 0, r + m_safe, r)
        q = jnp.where(r >= m_safe, q + 1, q)
        r = jnp.where(r >= m_safe, r - m_safe, r)
    return jnp.where(denom < 0, -q, q)


def mul_shift15(acc, q):
    """C ``(acc * q) / (1 << 15)`` where the product needs up to ~46 bits.

    This is the final per-frame normalisation (clownresampler.h:1033), the one
    place the reference relies on 64-bit intermediates (LP64 cc_s32f; SURVEY.md
    section 4 finding 4). Decompose |acc| = mh*2^15 + ml and |q| = nh*2^16 + nl:

      floor(|acc|*|q| / 2^15) = mh*|q| + 2*ml*nh + floor(ml*nl / 2^15)

    Each partial fits int32 whenever the true result does (the partials are
    each bounded by the result plus 2^16 slack), which holds for every real
    normalisation: the result is the output sample, bounded by the input scale
    times the filter overshoot. Truncation toward zero follows from applying
    the identity to magnitudes and reattaching the sign.
    """
    sign = jnp.where((acc < 0) ^ (q < 0), jnp.int32(-1), jnp.int32(1))
    m = jnp.abs(acc)
    n = jnp.abs(q)
    mh = m >> 15
    ml = m & 0x7FFF
    nh = n >> 16
    nl = n & 0xFFFF
    res = mh * n + 2 * (ml * nh) + ((ml * nl) >> 15)
    return sign * res


def split_increment(increment: int) -> tuple[int, int]:
    """Split a 16.16 increment into (hi, lo) 16-bit halves for int32-safe
    closed-form phase accumulation (see positions_from_state)."""
    return increment >> 16, increment & 0xFFFF


def positions_from_state(p0, f0, inc_hi, inc_lo, n):
    """Closed-form phase positions for output frames ``n`` (int32 vector).

    The reference advances the phase accumulator per output frame
    (clownresampler.h:1076-1078):
        frac += increment; int += frac >> 16; frac &= 0xFFFF
    which telescopes to  t(n) = f0 + n*increment,  pos(n) = p0 + (t >> 16),
    frac(n) = t & 0xFFFF.  Computing t in int32 would overflow for chunks of
    more than a few frames, so split the increment into 16-bit halves:
    f0 + n*inc_lo < 2^16 + n*2^16 stays in int32 for n < 2^15, and the hi part
    contributes whole input frames directly.

    Callers must keep n < 2^15 per launch (the chunk machinery tiles longer
    runs and recomputes p0/f0 host-side between tiles with exact Python ints).
    """
    t_lo = f0 + n * inc_lo
    frac = t_lo & jnp.int32(0xFFFF)
    pos = p0 + n * inc_hi + (t_lo >> 16)
    return pos, frac
