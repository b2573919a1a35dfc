"""Uniform-ratio lane launches: the resampling hot loop for many streams.

This replaces the reference's scalar inner MAC loop
(ClownResampler_LowestLevel_Resample, clownresampler.h:986-1035) with one
device computation over a block of output frames x lanes.

Layout: input is lane-major ``x[(S, L)] int32`` (sign-extended s16 samples)
with L = streams x channels; every lane shares the launch's phase sequence
(uniform ratio), so all per-frame quantities (window row, tap kernel values,
normaliser reciprocal) are computed once per launch (``precompute_launch``)
and broadcast across lanes. What remains per lane is a dense truncating
multiply-accumulate (fixedpoint.py).

One route serves every ratio, in plain XLA on every backend
(``resample_lanes``): a per-frame window row gather, the truncating MAC and
the normalise. It is bit-exact vs ops.convolve (tests/test_resample_ops.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu.lowlevel import DeviceState
from clownresampler_tpu.ops.convolve import window_geometry

# Max output frames per launch: device positions come from
# fx.positions_from_state, int32-exact only while f0 + n*inc_lo < 2^31,
# i.e. n < 2^15 in the worst case.
MAX_LAUNCH_FRAMES = 1 << 14

# The lanes route gathers an (N, T, L) int32 window block. Launches are cut
# so that block stays under this size even where XLA materialises it (the
# CPU backend does; wide ratios reach thousands of taps).
WINDOW_GATHER_BYTES = 1 << 30


def lanes_launch_frames(max_taps: int, lanes: int) -> int:
    """Most output frames one lanes-route launch may take (multiple of 8)."""
    n = WINDOW_GATHER_BYTES // (4 * max_taps * max(lanes, 1))
    return max(8, min(MAX_LAUNCH_FRAMES, n // 8 * 8))


@partial(jax.jit, static_argnames=("max_taps", "n_out"))
def precompute_launch(table, state: DeviceState, *, max_taps: int, n_out: int):
    """Per-output-frame scalars for a uniform-ratio launch.

    Returns (rows (N,), kvals (N, T), q (N,)): rows[n] is the first input row
    of frame n's tap window (pos + min_rel, clownresampler.h:995), kvals the
    masked LUT taps (1008-1021), q the 17.15 reciprocal (1025).
    """
    cfg = state.cfg
    n = jnp.arange(n_out, dtype=jnp.int32)
    pos, frac = fx.positions_from_state(
        state.position_integer,
        state.position_fractional,
        cfg.increment_hi,
        cfg.increment_lo,
        n,
    )
    min_rel, _max_rel, kernel_start, taps = window_geometry(cfg, frac)
    j = jnp.arange(max_taps, dtype=jnp.int32)
    kidx = kernel_start[:, None] + j[None, :] * cfg.kernel_step_size
    kidx = jnp.clip(kidx, 0, table.shape[0] - 1)
    kvals = jnp.where(j[None, :] < taps[:, None], jnp.take(table, kidx, axis=0), 0)
    q = fx.reciprocal_q31(jnp.sum(kvals, axis=1))
    return pos + min_rel, kvals, q


def launch_rows(rows, s: int, max_taps: int):
    """Window rows clamped so every tap row is inside an S-row input.

    Only padding frames (past the caller's natural count, results discarded)
    are ever moved: the callers' staging contract keeps every legal frame's
    window inside the buffer."""
    assert s >= max_taps, (s, max_taps)
    return jnp.clip(rows, 0, s - max_taps)


def _macc(win32, kval, acc):
    """One tap's multiply-accumulate with C-exact truncation.

    Implements trunc((x*k)/2^16) (clownresampler.h:1020, 625). The tap
    product spans exactly [-2^31, 2^31) (|x| <= 32768, k in [-9651, 65536],
    SURVEY.md section 7) so a single int32 multiply is exact; truncation
    toward zero is floor after adding 0xFFFF to negative products
    (p >> 31 is 0 or -1, so (p >> 31) & 0xFFFF is the exact bias).
    """
    p = win32 * kval
    return acc + ((p + ((p >> 31) & 0xFFFF)) >> 16)


def _finish(acc, q, clamp_s16: bool):
    out = fx.mul_shift15(acc, q)                      # 17.15 normalise
    if clamp_s16:
        # The clamp the reference's examples apply to every frame
        # (clownresampler.h:96-100); halves the output bytes.
        out = jnp.clip(out, -0x7FFF, 0x7FFF).astype(jnp.int16)
    return out


@partial(jax.jit, static_argnames=("max_taps", "n_out", "clamp_s16"))
def resample_lanes(table, x, state: DeviceState, *, max_taps: int, n_out: int,
                   clamp_s16: bool = False):
    """Any-ratio uniform launch in plain XLA; returns (n_out, L).

    The caller's input must hold every legal frame's ``max_taps``-row window
    (rows[n] + max_taps <= S); frames past the natural count are padding.
    """
    rows, kvals, q = precompute_launch(table, state, max_taps=max_taps, n_out=n_out)
    rows = launch_rows(rows, x.shape[0], max_taps)
    j = jnp.arange(max_taps, dtype=jnp.int32)
    win = x[rows[:, None] + j[None, :]]                              # (N, T, L)
    acc = jnp.sum(_macc(win, kvals[:, :, None], 0), axis=1)          # (N, L)
    return _finish(acc, q[:, None], clamp_s16)


def plan_launch(max_taps: int, n_out: int, clamp_s16: bool) -> tuple:
    """The static plan tuple of one ``multi_resample`` launch."""
    return (max_taps, n_out, clamp_s16)


@partial(jax.jit, static_argnames=("plans",))
def multi_resample(table, xs: tuple, states: tuple, plans: tuple) -> tuple:
    """Run several independent uniform-ratio launches as ONE device program.

    ``plans[i]`` is a hashable static tuple (max_taps, n_out, clamp_s16) from
    ``plan_launch``; xs[i]/states[i] are that launch's input block and phase
    state. A mixed-ratio fleet or a long emit then pays one program dispatch
    per chunk instead of one per launch.
    Returns a tuple of (n_out, L) outputs.
    """
    return tuple(
        resample_lanes(table, x, st, max_taps=max_taps, n_out=n_out, clamp_s16=clamp)
        for x, st, (max_taps, n_out, clamp) in zip(xs, states, plans))
