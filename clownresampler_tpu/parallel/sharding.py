"""Device-mesh sharding: scale the stream farm over several devices.

Two parallel axes (SURVEY.md section 2: the reference has no distributed
anything; these are device-mesh capabilities layered on the batch API):

* ``dp`` — data parallel over independent streams. Streams share nothing, so
  this is pure batch sharding: zero collectives.

* ``sp`` — sequence parallel over output frames *within* a stream. The phase
  accumulator is closed-form (t(n) = f0 + n*increment), so shard i can start
  directly at output frame i*F with a locally-recomputed state offset — the
  halo the reference carries between chunks (clownresampler.h:1143-1154)
  becomes overlapping reads of the replicated/sliced input, not communication.

Both compose on one 2-D mesh; all compute stays the bit-exact chunk kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from clownresampler_tpu.lowlevel import (
    DeviceState,
    natural_output_count,
    resample_chunk,
)
from clownresampler_tpu import fixedpoint as fx


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh. Defaults to all devices on the dp axis."""
    devices = devices if devices is not None else jax.devices()
    if dp is None:
        dp = len(devices) // sp
    devices = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(devices, ("dp", "sp"))


def _shift_state(state: DeviceState, n0):
    """Advance a stream state by n0 output frames (closed-form phase math)."""
    pos, frac = fx.positions_from_state(
        state.position_integer,
        state.position_fractional,
        state.cfg.increment_hi,
        state.cfg.increment_lo,
        n0,
    )
    return DeviceState(position_integer=pos, position_fractional=frac, cfg=state.cfg)


def sharded_resample_batch(
    mesh: Mesh,
    table,
    padded_inputs,       # (B, S, C) int16 — B sharded over dp
    total_input_frames,  # (B,) int32
    states: DeviceState, # stacked (B,) leaves
    output_quota,        # (B,) int32
    *,
    max_taps: int,
    n_out: int,          # total output frames per stream; split over sp
):
    """DP x SP sharded batched resample.

    Layout: streams shard over ``dp``; each stream's n_out output frames split
    over ``sp``, with every sp-shard recomputing its own phase offset locally
    (no collectives — the only "communication" is the replicated input read).
    Returns the same tuple as batch.resample_batch with outputs (B, n_out, C).
    """
    sp = mesh.shape["sp"]
    assert n_out % sp == 0, "n_out must divide over the sp axis"
    # positions_from_state/_shift_state require frame offsets < 2^15 to stay
    # int32-exact; n0 and the psum'd produced count both reach n_out.
    assert n_out <= 1 << 14, "n_out must be <= 2^14 per sharded launch"
    n_local = n_out // sp

    def per_shard(table, x, n_in, state, quota):
        # One dp-shard of streams, one sp-shard of output frames.
        i = jax.lax.axis_index("sp").astype(jnp.int32)
        n0 = i * jnp.int32(n_local)

        def one_stream(xs, ns, st, qs):
            st0 = _shift_state(st, n0)
            # Frames before this shard count against the stream quota.
            q_local = jnp.clip(qs - n0, 0, jnp.int32(n_local))
            out, produced, _, _, _ = resample_chunk(
                table, xs, ns, st0, q_local, max_taps=max_taps, n_out=n_local
            )
            return out, produced

        out, produced = jax.vmap(one_stream)(x, n_in, state, quota)

        # The only cross-shard exchange in the whole framework: sum the
        # per-shard frame counts over sp (a scalar per stream).
        # Everything else is recomputed locally from the closed-form phase —
        # identically on every sp shard, so the bookkeeping outputs are
        # replicated by construction.
        produced_tot = jax.lax.psum(produced, "sp")

        def bookkeeping(ns, st, q, prod):
            st_after = _shift_state(st, prod)
            delta = jnp.minimum(st_after.position_integer, ns)
            final = DeviceState(
                position_integer=st_after.position_integer - delta,
                position_fractional=st_after.position_fractional,
                cfg=st.cfg,
            )
            natural = natural_output_count(
                st.position_integer,
                st.position_fractional,
                st.cfg.increment_hi,
                st.cfg.increment_lo,
                ns,
            )
            exhausted = natural < jnp.minimum(q, jnp.int32(n_out))
            return delta, final, exhausted

        consumed, final_state, exhausted = jax.vmap(bookkeeping)(
            n_in, state, quota, produced_tot
        )
        return out, produced_tot, consumed, final_state, exhausted

    specs_in = (
        P(),                      # table replicated
        P("dp", None, None),      # inputs: streams over dp, replicated over sp
        P("dp"),                  # totals
        jax.tree.map(lambda _: P("dp"), states),
        P("dp"),
    )
    specs_out = (
        P("dp", "sp", None),      # outputs: frames over sp
        P("dp"),
        P("dp"),
        jax.tree.map(lambda _: P("dp"), states),
        P("dp"),
    )
    fn = shard_map(
        per_shard, mesh=mesh, in_specs=specs_in, out_specs=specs_out, check_vma=False
    )
    return jax.jit(fn)(table, padded_inputs, total_input_frames, states, output_quota)


def sharded_uniform_resample(
    mesh: Mesh,
    table,
    x,                   # (S, L) int32 lane-major; L sharded over dp
    state: DeviceState,  # scalar state, replicated
    *,
    max_taps: int,
    n_out: int,
):
    """Multi-device uniform launch: shard the lane (stream x channel) axis
    over dp.

    Streams share nothing, so this is pure data parallelism: each device runs
    the lanes route (ops/resample.py) on its lane shard with the replicated
    scalar state and LUT — zero collectives. Returns (n_out, L) int32 sharded
    the same way as the input.
    """
    from clownresampler_tpu.ops.resample import resample_lanes

    def per_shard(table, x_local, st):
        return resample_lanes(table, x_local, st, max_taps=max_taps, n_out=n_out)

    specs_in = (
        P(),
        P(None, "dp"),
        jax.tree.map(lambda _: P(), state),
    )
    fn = shard_map(
        per_shard, mesh=mesh, in_specs=specs_in, out_specs=P(None, "dp"),
        check_vma=False,
    )
    return jax.jit(fn)(table, x, state)
