"""Batched multi-stream resampling with per-stream state.

The reference processes one stream, one frame at a time. On a device the
natural unit is a *batch of independent streams* (SURVEY.md section 2: data parallelism
over streams is the new capability the north star demands; streams share
nothing, so there is no cross-stream communication to express). Each stream
carries its own ratio/phase state, so a mixed-ratio farm is just a stacked
state pytree pushed through a vmapped chunk kernel.

All ``(B, ...)``-leading arrays; states are stacked DeviceState pytrees.
Bit-exactness per stream is inherited from ops.convolve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from clownresampler_tpu.configure import Configuration
from clownresampler_tpu.lowlevel import DeviceState, make_device_state, resample_chunk


def stack_states(states: list[DeviceState]) -> DeviceState:
    """Stack per-stream DeviceStates into one (B,)-leaf pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def make_batch_state(configs_increments: list[tuple[Configuration, int]]) -> DeviceState:
    """Build a stacked state for B streams at position zero.

    configs_increments: per-stream (Configuration, increment) pairs, e.g. the
    mixed-ratio farm of BASELINE.json config 5.
    """
    return stack_states(
        [make_device_state(0, 0, cfg, inc) for cfg, inc in configs_increments]
    )


@partial(jax.jit, static_argnames=("max_taps", "n_out"))
def resample_batch(
    table,               # (table_size,) int32, shared by all streams
    padded_inputs,       # (B, S, C) int16
    total_input_frames,  # (B,) int32
    states: DeviceState, # stacked, (B,) leaves
    output_quota,        # (B,) int32
    *,
    max_taps: int,
    n_out: int,
):
    """vmapped resample_chunk over the stream axis.

    Returns (outputs (B, n_out, C) int32, produced (B,), consumed (B,),
    new_states, input_exhausted (B,)). Streams that produce fewer than n_out
    frames have their tails zero-masked; ``produced`` is authoritative.
    """
    fn = lambda x, n, st, q: resample_chunk(
        table, x, n, st, q, max_taps=max_taps, n_out=n_out
    )
    return jax.vmap(fn)(padded_inputs, total_input_frames, states, output_quota)

