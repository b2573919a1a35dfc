"""Low-level streaming API: phase-accumulator state over pre-padded input.

Functional re-expression of ClownResampler_LowLevel_{Init,Adjust,Resample}
(clownresampler.h:640-648, 1039-1094). The reference runs a sequential
per-output-frame loop whose only state is the 16.16 phase accumulator; between
Adjust calls the accumulation is linear, so output frame n has the closed-form
position  t(n) = f0 + n*increment,  pos(n) = p0 + (t >> 16),
frac(n) = t & 0xFFFF  — which turns the loop into one batched device
computation per chunk.

Two layers are provided:

* ``resample_chunk`` — pure, jit-able: static-shape output tile + masks, with
  the reference's exact termination bookkeeping (position carry on input
  exhaustion, clownresampler.h:1063-1068; rewind on output-full, 1084-1088).
  This is the building block of the batched and sharded paths.

* ``LowLevelResampler`` — host streaming class mirroring the C API surface,
  including the per-frame output-callback contract. Bookkeeping uses exact
  Python ints (no overflow for arbitrarily long streams); the math runs on
  device through the uniform-ratio launch route (ops/resample.py).

Input padding contract is the reference's (clownresampler.h:725-733): the
buffer must carry ``integer_stretched_kernel_radius`` extra frames before and
after the chunk, holding neighbouring stream data (or zeros at stream edges),
not counted in ``total_input_frames``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu.configure import Configuration, configure
from clownresampler_tpu.models import DEFAULT_MODEL, KernelModel
from clownresampler_tpu.ops.convolve import ConfigScalars, convolve_frames

# Keep n*increment_lo inside int32 (fixedpoint.positions_from_state).
MAX_CHUNK_OUTPUT_FRAMES = 1 << 14

class DeviceState(NamedTuple):
    """Traced int32 mirror of ClownResampler_LowLevel_State (640-648)."""

    position_integer: jnp.ndarray
    position_fractional: jnp.ndarray
    cfg: ConfigScalars


def make_device_state(
    position_integer: int, position_fractional: int, cfg: Configuration, increment: int
) -> DeviceState:
    return DeviceState(
        position_integer=jnp.asarray(position_integer, jnp.int32),
        position_fractional=jnp.asarray(position_fractional, jnp.int32),
        cfg=ConfigScalars.from_configuration(cfg, increment),
    )


def natural_output_count(p0, f0, inc_hi, inc_lo, total_input_frames):
    """Number of frames the reference loop produces before the position check
    (clownresampler.h:1063) trips: smallest n with p0 + ((f0+n*inc) >> 16) >= N,
    i.e. ceil(((N - p0) << 16 - f0) / inc), clamped at 0.

    int32-safe for N < 2^14 (callers tile larger inputs).
    """
    num = ((total_input_frames - p0) << 16) - f0
    inc = (inc_hi << 16) + inc_lo  # increments that large force tiny N; see note
    n = jnp.where(num > 0, (num + inc - 1) // jnp.maximum(inc, 1), 0)
    return n


@partial(jax.jit, static_argnames=("max_taps", "n_out"))
def resample_chunk(
    table,
    padded_input,         # (N_in + 2*radius_max, C) int16
    total_input_frames,   # int32 scalar: frames, excluding padding
    state: DeviceState,
    output_quota,         # int32 scalar: max frames to emit this call
    *,
    max_taps: int,
    n_out: int,           # static output tile capacity
):
    """One LowLevel_Resample call as a pure function.

    Returns (output (n_out, C) int32 zero-masked past ``produced``, produced,
    consumed, new_state, input_exhausted) with the reference's exact return
    semantics: ``input_exhausted`` mirrors the cc_true/cc_false return of
    clownresampler.h:1058-1092 — true iff the position check exited the loop,
    which requires strictly fewer natural frames than the output quota (when
    the quota trips on the final frame the reference reports output-full).
    """
    assert n_out <= MAX_CHUNK_OUTPUT_FRAMES
    p0 = state.position_integer
    f0 = state.position_fractional
    inc_hi = state.cfg.increment_hi
    inc_lo = state.cfg.increment_lo

    natural = natural_output_count(p0, f0, inc_hi, inc_lo, total_input_frames)
    quota = jnp.minimum(output_quota, jnp.int32(n_out))
    produced = jnp.minimum(natural, quota)

    n = jnp.arange(n_out, dtype=jnp.int32)
    pos, frac = fx.positions_from_state(p0, f0, inc_hi, inc_lo, n)

    out = convolve_frames(table, padded_input, pos, frac, state.cfg, max_taps)
    out = jnp.where((n < produced)[:, None], out, 0)

    # Advance state past the produced frames, then apply the unified
    # carry/rewind: delta = min(position, N) covers both exit paths
    # (input-exhausted carry 1063-1068 and output-full rewind 1084-1088).
    p_after, f_after = fx.positions_from_state(p0, f0, inc_hi, inc_lo, produced)
    delta = jnp.minimum(p_after, total_input_frames)
    consumed = delta
    new_state = DeviceState(
        position_integer=p_after - delta,
        position_fractional=f_after,
        cfg=state.cfg,
    )
    input_exhausted = natural < quota
    return out, produced, consumed, new_state, input_exhausted


@partial(jax.jit, static_argnames=("max_taps", "n_out", "radius"))
def resample_scan(
    table,
    chunks,              # (K, n_in, L) int16/int32: K successive input chunks
    state: DeviceState,  # cfg radius must equal `radius`
    *,
    max_taps: int,
    n_out: int,          # static per-chunk output cap; use
                         # ((n_in + 2*radius) << 16) // increment + slack so the
                         # initial radius backlog can drain through any one step
    radius: int,         # static integer_stretched_kernel_radius
):
    """Whole-stream resampling as ONE jitted lax.scan over input chunks.

    The reference's high-level layer refills a staging buffer and memmoves a
    2*radius dead-zone halo between refills (clownresampler.h:1143-1154); here
    the halo is the scan carry: each step assembles [halo | chunk], resamples
    every frame visible against n_in (position carry keeps the leftover
    fraction in the state, 1063-1068), and hands the trailing 2*radius rows to
    the next step. No host round-trips between chunks — the entire stream
    pipeline is a single device computation.

    Returns (outputs (K, n_out, L) int32 zero-masked, produced (K,), state',
    backlog bool). ``backlog`` is True iff some step's natural frame count
    exceeded the static ``n_out`` cap — the caller undersized n_out and
    backlogged frames' windows may have slid out of the carried halo, so the
    outputs are NOT trustworthy; size n_out by the rule above.
    Leading edge: seed the first halo with zeros (done here); trailing edge:
    append a radius-frame zero chunk to flush, as ResampleEnd does (1242-1250).
    """
    k, n_in, l = chunks.shape
    # natural_output_count shifts (n_in - p0) left by 16 in int32.
    assert n_in < 1 << 14, "scan chunks must be < 2^14 frames (tile longer input)"
    halo0 = jnp.zeros((2 * radius, l), chunks.dtype)

    # Buffer row r maps to stream frame r - 2*radius (the halo occupies the
    # first 2*radius rows), while the C window contract puts stream frame 0 at
    # row `radius` (clownresampler.h:725-733). Bias positions by +radius going
    # in and strip it from the returned state.
    state = DeviceState(
        position_integer=state.position_integer + jnp.int32(radius),
        position_fractional=state.position_fractional,
        cfg=state.cfg,
    )

    def step(carry, chunk):
        st, halo = carry
        buffer = jnp.concatenate([halo, chunk], axis=0)
        natural = natural_output_count(
            st.position_integer,
            st.position_fractional,
            st.cfg.increment_hi,
            st.cfg.increment_lo,
            jnp.int32(n_in),
        )
        out, produced, _consumed, st2, _flag = resample_chunk(
            table,
            buffer,
            jnp.int32(n_in),
            st,
            jnp.int32(1 << 30),
            max_taps=max_taps,
            n_out=n_out,
        )
        new_halo = jax.lax.slice_in_dim(buffer, n_in, n_in + 2 * radius, axis=0)
        return (st2, new_halo), (out, produced, natural > jnp.int32(n_out))

    (state_out, _halo), (outputs, produced, over) = jax.lax.scan(
        step, (state, halo0), chunks
    )
    state_out = DeviceState(
        position_integer=state_out.position_integer - jnp.int32(radius),
        position_fractional=state_out.position_fractional,
        cfg=state_out.cfg,
    )
    return outputs, produced, state_out, jnp.any(over)


@partial(
    jax.jit,
    static_argnames=("max_taps", "n_out", "radius", "split", "pipeline"),
)
def resample_scan_fused(
    table,
    chunks,              # (K, n_in, L) int16/int32
    state: DeviceState,
    *,
    max_taps: int,
    n_out: int,          # per-chunk cap: ((n_in + 2*radius) << 16)//inc + slack
    radius: int,
    split: int = 1,      # independent lane-column sub-fleets per scan step
    pipeline: bool = True,   # double-buffer the staged input across steps
):
    """resample_scan with a uniform-ratio launch as the engine.

    Same semantics as resample_scan (one jitted lax.scan, halo carry, radius
    position bias) but each step runs the uniform-ratio launch route
    (ops/resample.py) over the whole lane fleet, instead of vmapping the per-stream oracle — the
    high-level chunk loop (clownresampler.h:1138-1173) as one device
    computation for ANY ratio.

    ``split`` runs the fleet as that many INDEPENDENT sub-fleets of L/split
    lanes inside the same scan, each with its own halo/state carry and
    staging buffer. Bit-exact for any split: lanes are independent streams,
    the per-fleet math is identical (tests/test_scan.py).

    ``pipeline`` double-buffers the staged engine input through the scan
    carry: step t's engine consumes the buffer staged at step t-1, while
    step t itself stages chunk t+1's buffer (halo slice + int16->int32 widen
    + slack concat). Bit-exact either way — the engine sees byte-identical
    buffers.

    Returns (outputs (K, n_out, L) int32 zero-masked, produced (K,), state',
    backlog bool); ``backlog`` as in resample_scan.
    """
    from clownresampler_tpu.ops.resample import multi_resample, plan_launch

    k, n_in, l = chunks.shape
    assert n_in < 1 << 14
    plan = plan_launch(max_taps, n_out, False)
    # Legal windows lie inside [halo | chunk]; reads run max_taps rows from a
    # window start.
    slack = max_taps + 8

    def engine(buffer, st):
        return multi_resample(table, (buffer,), (st,), (plan,))[0]

    assert l % split == 0, "chunk lanes must divide evenly into split sub-fleets"
    l_sub = l // split
    halo0 = jnp.zeros((2 * radius, l_sub), jnp.int32)
    zeros_slack = jnp.zeros((slack, l_sub), jnp.int32)

    state = DeviceState(
        position_integer=state.position_integer + jnp.int32(radius),
        position_fractional=state.position_fractional,
        cfg=state.cfg,
    )

    def stage(halo, chunk):
        return jnp.concatenate([halo, chunk.astype(jnp.int32), zeros_slack], axis=0)

    def run_engine(st, buffer):
        natural = natural_output_count(
            st.position_integer,
            st.position_fractional,
            st.cfg.increment_hi,
            st.cfg.increment_lo,
            jnp.int32(n_in),
        )
        produced = jnp.minimum(natural, jnp.int32(n_out))
        out = engine(buffer, st)
        n = jnp.arange(n_out, dtype=jnp.int32)
        out = jnp.where((n < produced)[:, None], out, 0)

        p_after, f_after = fx.positions_from_state(
            st.position_integer,
            st.position_fractional,
            st.cfg.increment_hi,
            st.cfg.increment_lo,
            produced,
        )
        delta = jnp.minimum(p_after, jnp.int32(n_in))
        st2 = DeviceState(
            position_integer=p_after - delta,
            position_fractional=f_after,
            cfg=st.cfg,
        )
        return st2, out, produced, natural > jnp.int32(n_out)

    def substep(st, halo, chunk):
        buffer = stage(halo, chunk)
        st2, out, produced, over = run_engine(st, buffer)
        new_halo = jax.lax.slice_in_dim(buffer, n_in, n_in + 2 * radius, axis=0)
        return st2, new_halo, out, produced, over

    chunk_cols = tuple(
        jax.lax.slice_in_dim(chunks, i * l_sub, (i + 1) * l_sub, axis=2)
        for i in range(split)
    )

    if pipeline:
        # Double-buffered: the carry holds each sub-fleet's STAGED buffer;
        # iteration t runs the engine on it (staged at t-1) and stages
        # chunk t+1's buffer from its tail halo — two independent dependency
        # chains inside one iteration, so the widen/concat copy can hide
        # under the kernels. The last iteration restages chunk K-1 into a
        # never-consumed buffer (cheaper than predicating the slice).
        def substep_pipe(st, buf, t):
            st2, out, produced, over = run_engine(st, buf)
            new_halo = jax.lax.slice_in_dim(buf, n_in, n_in + 2 * radius, axis=0)
            return st2, new_halo, out, produced, over

        def step_pipe(carry, t):
            sts, bufs = carry
            results = [substep_pipe(st, buf, t) for st, buf in zip(sts, bufs)]
            t_next = jnp.minimum(t + 1, jnp.int32(k - 1))
            bufs2 = tuple(
                stage(r[1], jax.lax.dynamic_index_in_dim(cc, t_next, 0,
                                                         keepdims=False))
                for r, cc in zip(results, chunk_cols)
            )
            sts2 = tuple(r[0] for r in results)
            outs = tuple(r[2] for r in results)
            return (sts2, bufs2), (outs, results[0][3], results[0][4])

        bufs0 = tuple(
            stage(halo0, jax.lax.index_in_dim(cc, 0, 0, keepdims=False))
            for cc in chunk_cols
        )
        (states_out, _bufs), (outputs_t, produced, over) = jax.lax.scan(
            step_pipe,
            (tuple(state for _ in range(split)), bufs0),
            jnp.arange(k, dtype=jnp.int32),
        )
    else:
        def step(carry, chunks_t):
            sts, halos = carry
            results = [
                substep(st, halo, chunk)
                for st, halo, chunk in zip(sts, halos, chunks_t)
            ]
            sts2 = tuple(r[0] for r in results)
            halos2 = tuple(r[1] for r in results)
            outs = tuple(r[2] for r in results)
            # Every sub-fleet shares the (scalar) phase sequence; report
            # fleet 0's.
            return (sts2, halos2), (outs, results[0][3], results[0][4])

        (states_out, _halos), (outputs_t, produced, over) = jax.lax.scan(
            step,
            (tuple(state for _ in range(split)), tuple(halo0 for _ in range(split))),
            chunk_cols,
        )
    outputs = outputs_t[0] if split == 1 else jnp.concatenate(outputs_t, axis=2)
    state_out = DeviceState(
        position_integer=states_out[0].position_integer - jnp.int32(radius),
        position_fractional=states_out[0].position_fractional,
        cfg=states_out[0].cfg,
    )
    return outputs, produced, state_out, jnp.any(over)


# ---------------------------------------------------------------------------
# Host streaming API (exact-bookkeeping mirror of the C low-level API)
# ---------------------------------------------------------------------------

OutputCallback = Callable[[np.ndarray], bool]

# Independent tile launches fused per device program by the batched tile
# dispatch (_compute_frames). Fusing pays one program dispatch per group
# instead of one per tile; 4 per program keeps program size and compile time
# bounded.
TILE_LAUNCH_GROUP = 4


def _pack_super_groups(
    descs: list, ch: int, budget: int
) -> list[list[tuple[int, int]]]:
    """Pack tile descriptors into launch groups and budgeted cycles.

    Groups are runs of consecutive same-shape tiles (same n_pad and rows),
    TILE_LAUNCH_GROUP tiles max — each group becomes one fused device
    program. Super-groups are runs of consecutive groups whose combined
    resident footprint (int16 windows + ch-lane int32 outputs, plus the
    current program's transient widened int32 windows) fits ``budget``;
    each super-group runs one upload->launch->download cycle and drops its
    device references before the next, bounding device memory for
    arbitrarily long streams.
    """
    groups = []
    i = 0
    while i < len(descs):
        j = i + 1
        while (
            j < len(descs)
            and j - i < TILE_LAUNCH_GROUP
            and descs[j][1:3] == descs[i][1:3]
        ):
            j += 1
        groups.append((i, j))
        i = j

    super_groups: list[list[tuple[int, int]]] = []
    cur: list[tuple[int, int]] = []
    resident = 0
    for (i, j) in groups:
        g_res = sum(
            descs[k][2] * ch * 2 + descs[k][1] * ch * 4 for k in range(i, j)
        )
        g_tmp = sum(descs[k][2] * ch * 4 for k in range(i, j))
        if cur and resident + g_res + g_tmp > budget:
            super_groups.append(cur)
            cur, resident = [], 0
        cur.append((i, j))
        resident += g_res
    super_groups.append(cur)
    return super_groups


@partial(jax.jit, static_argnames=("plans",))
def _grouped_packed_launch(table, xs, f0s, cfg, plans):
    """Run a group of independent resample tiles as ONE device program.

    ``xs[i]`` is tile i's input window as the HOST uploaded it — (rows_i, ch)
    int16, only the stream's real channels — widened to int32 ON DEVICE, so
    host->device traffic stays at 2 bytes per sample. ``f0s[i]`` is tile i's
    16.16 phase fraction (tile positions are rebased to the window start, so
    position_integer is always 0 here).
    """
    from clownresampler_tpu.ops.resample import multi_resample

    states = tuple(
        DeviceState(
            position_integer=jnp.asarray(0, jnp.int32),
            position_fractional=f0s[i],
            cfg=cfg,
        )
        for i in range(len(xs))
    )
    return multi_resample(
        table, tuple(x.astype(jnp.int32) for x in xs), states, plans)


def _device_budget_bytes() -> int:
    """Device bytes one batched dispatch cycle may keep resident: an eighth
    of the device's reported memory (the rest stays free for the compiled
    programs' temporaries and other users of the device), or 2 GiB where the
    backend reports none."""
    from clownresampler_tpu import platform

    limit = platform.device_memory_bytes()
    return limit // 8 if limit else 2 << 30


@dataclass
class LowLevelResampler:
    """Stateful host-side mirror of the C low-level API.

    ``init``/``adjust``/``resample`` correspond one-to-one to
    ClownResampler_LowLevel_{Init,Adjust,Resample}. Positions are exact Python
    ints; per-chunk math is dispatched to the device in tiles.
    """

    channels: int
    model: KernelModel = DEFAULT_MODEL
    position_integer: int = 0
    position_fractional: int = 0
    increment: int = 0
    config: Optional[Configuration] = None
    # static tap bound for compiled kernels; fixed at init so adjust() never
    # changes compiled shapes (mirrors the high-level radius rule).
    _max_taps: int = 0
    # Device-resident byte budget for ONE upload->launch->download cycle of
    # the batched tile dispatch (_compute_frames); None derives it from the
    # device (_device_budget_bytes). A cycle keeps all its int16 windows and
    # ch-lane int32 outputs resident at once; streams whose tiles exceed the
    # budget run as several sequential cycles, so a resample() call over an
    # arbitrarily long input keeps a bounded device footprint.
    BATCH_DEVICE_BUDGET_BYTES = None

    @classmethod
    def init(
        cls,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: int,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
    ) -> Optional["LowLevelResampler"]:
        """ClownResampler_LowLevel_Init (clownresampler.h:1044-1050).

        ``max_radius`` optionally reserves tap-window capacity for later
        ``adjust`` calls to wider ratios (the C low-level API has no such
        limit because it is scalar; compiled tile shapes need a bound).
        """
        self = cls(channels=channels, model=model)
        if not self.adjust(input_rate, output_rate, low_pass_rate, _initial=True):
            return None
        radius_bound = max(
            self.config.integer_stretched_kernel_radius, max_radius or 0
        )
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        return self

    def adjust(
        self, input_rate: int, output_rate: int, low_pass_rate: int, _initial=False
    ) -> bool:
        """ClownResampler_LowLevel_Adjust (1052-1056): recompute increment and
        stretching mid-stream; position is untouched. Fails only on crazy
        ratios (scale >= 0x1000, clownresampler.h:974-975)."""
        cfg = configure(
            input_rate,
            output_rate,
            low_pass_rate,
            radius=self.model.radius,
            resolution=self.model.resolution,
        )
        if cfg is None:
            return False
        if not _initial and 2 * cfg.integer_stretched_kernel_radius > self._max_taps:
            # The C low-level API permits unrestricted radius growth on Adjust
            # (only the high-level API restricts it, clownresampler.h:1195);
            # growing the static tap bound just recompiles the kernels.
            self._max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
        self.increment = fx.calculate_ratio(input_rate, output_rate)
        self.config = cfg
        return True

    # -- core chunk computation ------------------------------------------

    def _natural_count(self, total_input_frames: int) -> int:
        num = (
            (total_input_frames - self.position_integer) << 16
        ) - self.position_fractional
        if num <= 0:
            return 0
        return -(-num // self.increment)

    def _compute_frames(self, padded_input: np.ndarray, n_frames: int) -> np.ndarray:
        """Convolve output frames [0, n_frames) from the current state.

        Tiles the stream so device index math stays in int32; each tile gets
        its own row window of the input (positions rebased to the window
        start), and tile sizes and windows are bucketed to bound
        recompilation. Tiles launch TILE_LAUNCH_GROUP per device program,
        windows uploaded before a cycle's first launch and outputs
        downloaded after its last.
        """
        from clownresampler_tpu.ops.resample import lanes_launch_frames, plan_launch

        if n_frames == 0:
            return np.zeros((0, self.channels), np.int32)
        ch = self.channels
        # Launch at the CURRENT ratio's tap width, not the reserve: kernel
        # values past a frame's tap count are masked to zero, so any launch
        # width >= the current one is bit-exact, and the MAC volume and the
        # window uploads scale with the launch width.
        taps = min(
            self._max_taps,
            fx.round_up(2 * self.config.integer_stretched_kernel_radius, 8),
        )
        max_tile = min(MAX_CHUNK_OUTPUT_FRAMES, lanes_launch_frames(taps, ch))

        # ---- tile geometry: positions are exact host ints, so every tile's
        # window row and phase fraction are closed-form from `done`
        descs = []  # (tile, n_pad, rows, p0, f0)
        done = 0
        while done < n_frames:
            tile = min(n_frames - done, max_tile)
            t = self.position_fractional + (done * self.increment)
            p0 = self.position_integer + (t >> 16)
            n_pad = fx.round_up(tile, 256 if tile >= 1024 else 64)
            # Row window [p0, p0 + rows), zero-padded past the stream end.
            # Frame n of the padded tile starts its window at most
            # ((n_pad * increment) >> 16) + 3 rows in and reads `taps` rows,
            # so no launch is clamped. Rows bucket to powers of two so the
            # bucket count bounds recompiles.
            rows = ((n_pad * self.increment) >> 16) + taps + 8
            bucket = 1024
            while bucket < rows:
                bucket *= 2
            descs.append((tile, n_pad, bucket, p0, t & 0xFFFF))
            done += tile

        table = self.model.table()
        cfg = make_device_state(0, 0, self.config, self.increment).cfg
        budget = self.BATCH_DEVICE_BUDGET_BYTES or _device_budget_bytes()
        chunks = []
        for sg in _pack_super_groups(descs, ch, budget):
            lo, hi = sg[0][0], sg[-1][1]
            # uploads (all before the super-group's first launch)
            windows = []
            for tile, n_pad, rows, p0, f0 in descs[lo:hi]:
                w = np.zeros((rows, ch), np.int16)
                avail = min(rows, padded_input.shape[0] - p0)
                if avail > 0:
                    w[:avail] = padded_input[p0 : p0 + avail]
                windows.append(jnp.asarray(w))
            f0_arrays = [
                jnp.asarray(np.array([descs[k][4] for k in range(i, j)], np.int32))
                for i, j in sg
            ]

            # launch stream (no interleaved host transfers within the cycle)
            outs = []
            for (i, j), f0s in zip(sg, f0_arrays):
                plans = tuple(
                    plan_launch(taps, descs[k][1], False)
                    for k in range(i, j)
                )
                outs.extend(_grouped_packed_launch(
                    table, tuple(windows[i - lo : j - lo]), f0s, cfg, plans))

            # downloads, then drop EVERY device reference the cycle holds
            # (windows, phases, outputs) before the next cycle's uploads —
            # otherwise this cycle's outputs stay resident alongside the next
            # cycle's windows and peak use exceeds the budget.
            chunks.extend(
                np.asarray(o)[: dsc[0]] for o, dsc in zip(outs, descs[lo:hi])
            )
            del windows, f0_arrays, outs
        return np.concatenate(chunks, axis=0)

    def _advance(self, n_frames: int) -> None:
        t = self.position_fractional + n_frames * self.increment
        self.position_integer += t >> 16
        self.position_fractional = t & 0xFFFF

    def resample(
        self,
        padded_input: np.ndarray,     # (N + 2*radius, channels) int16
        total_input_frames: int,
        output_callback: Optional[OutputCallback] = None,
        output_limit: Optional[int] = None,
    ) -> tuple[bool, int, np.ndarray]:
        """ClownResampler_LowLevel_Resample (1058-1092).

        Returns (input_exhausted, remaining_input_frames, output_frames).
        ``output_callback(frame) -> bool`` reproduces the per-frame contract
        (return False to stop); ``output_limit`` is the array-API equivalent
        (stop after N frames). With neither, runs to input exhaustion.
        """
        padded_input = np.ascontiguousarray(padded_input, dtype=np.int16).reshape(
            -1, self.channels
        )
        natural = self._natural_count(total_input_frames)

        quota = natural if output_limit is None else min(natural, output_limit)
        frames = self._compute_frames(padded_input, quota)

        # "refused" mirrors the output callback returning 0: the reference
        # reports output-full (cc_false) even when the refusal lands on the
        # final natural frame, because the refusal exits the loop before the
        # position check runs (clownresampler.h:1081-1089).
        produced = quota
        refused = False
        if output_callback is not None:
            for i in range(quota):
                if not output_callback(frames[i]):
                    produced = i + 1
                    refused = True
                    break
        if not refused and output_limit is not None and natural >= output_limit:
            refused = True
        frames = frames[:produced]

        self._advance(produced)
        # Unified carry/rewind (1063-1068, 1084-1088).
        delta = min(self.position_integer, total_input_frames)
        remaining = total_input_frames - delta
        self.position_integer -= delta

        return not refused, remaining, frames

    def state_tuple(self) -> tuple[int, int, int, int, int, int, int]:
        """(pos_int, pos_frac, increment, stretched, int_radius, delta, step) —
        for oracle state-equality tests."""
        c = self.config
        return (
            self.position_integer,
            self.position_fractional,
            self.increment,
            c.stretched_kernel_radius,
            c.integer_stretched_kernel_radius,
            c.stretched_kernel_radius_delta,
            c.kernel_step_size,
        )


def resample_array(
    input_frames: np.ndarray,
    input_rate: int,
    output_rate: int,
    low_pass_rate: int,
    model: KernelModel = DEFAULT_MODEL,
) -> np.ndarray:
    """One-shot whole-buffer resample (the tests/test-low-level.c usage:
    caller pads with radius zero-frames both ends, clownresampler.h:725-733).

    input_frames: (N, channels) int16. Returns (M, channels) int32 wide
    samples, M = natural output count.
    """
    input_frames = np.asarray(input_frames, dtype=np.int16)
    if input_frames.ndim == 1:
        input_frames = input_frames[:, None]
    n, channels = input_frames.shape
    rs = LowLevelResampler.init(channels, input_rate, output_rate, low_pass_rate, model)
    if rs is None:
        raise ValueError("unsupported ratio")
    r = rs.config.integer_stretched_kernel_radius
    padded = np.zeros((n + 2 * r, channels), dtype=np.int16)
    padded[r : r + n] = input_frames
    _, _, out = rs.resample(padded, n)
    return out
