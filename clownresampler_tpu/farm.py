"""Transcode farm: steady-state chunked resampling of many parallel streams.

This is the production path the scalar reference cannot express: B streams
flow through one uniform-ratio launch (ops/resample.py) as lanes of a
lane-major staging buffer, with the host side doing exactly what the
reference's high-level layer does for one stream — staging buffer, halo
carry, edge padding (clownresampler.h:1096-1252) — on device, or in host
memory via the native C++ engine (native/stage.cpp).

``UniformStreamFarm`` drives B same-ratio streams (one shared phase state).
Mixed-ratio fleets are ratio-grouped: one farm per distinct ratio (streams
share nothing, so grouping is free — SURVEY.md section 2, parallelism notes).
Dynamic ratio changes (pitch bends) are ``adjust`` between chunks, mirroring
LowLevel_Adjust semantics (clownresampler.h:1052-1056): position carries over,
only the increment/stretching change.

Bit-exactness: each stream's output is identical to running the reference
(and to LowLevelResampler) on that stream alone — tests/test_farm.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu import platform
from clownresampler_tpu.configure import Configuration, configure
from clownresampler_tpu.lowlevel import make_device_state
from clownresampler_tpu.models import DEFAULT_MODEL, KernelModel
from clownresampler_tpu.ops.resample import lanes_launch_frames, multi_resample, plan_launch
from clownresampler_tpu.utils import native


def staging_capacity(radius_bound: int, chunk_frames: int, max_taps: int) -> int:
    """Rows of a farm's staging buffer: [left halo | data | read slack].

    Data fills at most 3*radius_bound + chunk_frames rows: the
    2*radius_bound halo kept between chunks, one chunk, and flush's
    radius_bound zero rows. Every launch reads ``max_taps`` rows from each
    frame's window start, and a legal frame's window starts inside the data,
    so max_taps rows of slack keep every legal read in the buffer (padding
    frames are clamped inside it, ops.resample.launch_rows).
    """
    return 3 * radius_bound + chunk_frames + max_taps


class UniformStreamFarm:
    """B same-ratio streams, chunked, bit-exact.

    Feed fixed-size chunks with :meth:`process`; finish with :meth:`flush`.
    Outputs are wide int32 frames per stream, exactly matching the reference's
    per-stream results for the concatenated input.
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: Optional[int] = None,
        chunk_frames: int = 4096,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        device_staging: Optional[bool] = None,
        clamp_s16: bool = False,
        lane_multiple: int = 1,
    ):
        low_pass_rate = low_pass_rate if low_pass_rate is not None else max(input_rate, output_rate)
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=model.radius, resolution=model.resolution)
        if cfg is None:
            raise ValueError("unsupported ratio (kernel scale >= 0x1000)")
        self.n_streams = n_streams
        self.channels = channels
        self.chunk_frames = chunk_frames
        self.model = model
        self.clamp_s16 = clamp_s16  # emit clamped int16 (serving; halves D2H)
        self._table = jnp.asarray(model.table())

        # lane_multiple: the sharded farm pads lanes to whole per-device shards
        self._lanes = fx.round_up(n_streams * channels, lane_multiple)
        radius_bound = max(cfg.integer_stretched_kernel_radius, max_radius or 0)
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        self._radius_bound = radius_bound

        # Host streaming state (exact Python ints) + device scalars per launch.
        self.position_integer = 0
        self.position_fractional = 0
        self._set_config(cfg, fx.calculate_ratio(input_rate, output_rate))

        # Row r of the staging buffer is sample_index r in the reference's
        # convolution (clownresampler.h:995): logical stream frame f lives at
        # row f + radius_bound.
        self._capacity = staging_capacity(radius_bound, chunk_frames, self._max_taps)

        # Device-resident staging (the default on the accelerator): the
        # buffer lives in device memory; each process() uploads only the new
        # int16 chunk and stages/shifts on device.
        if device_staging is None:
            device_staging = platform.on_accelerator()
        self._device_staging = device_staging
        if device_staging:
            self._staging = jnp.zeros((self._capacity, self._lanes), jnp.int32)
        else:
            self._staging = np.zeros((self._capacity, self._lanes), np.int32)
        self._fill = radius_bound      # rows of valid data (left zero halo)
        self._pending_slide = None     # (consumed, keep) parked by defer_slide

    # ------------------------------------------------------------------
    def _set_config(self, cfg: Configuration, increment: int) -> None:
        self.config = cfg
        self.increment = increment

    def adjust(self, input_rate: int, output_rate: int, low_pass_rate: Optional[int] = None) -> bool:
        """Mid-stream ratio change (pitch bend); position carries over.

        Like HighLevel_Adjust (clownresampler.h:1183-1209), the radius may not
        grow past the construction-time bound (pass max_radius to reserve)."""
        low_pass_rate = low_pass_rate if low_pass_rate is not None else max(input_rate, output_rate)
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=self.model.radius, resolution=self.model.resolution)
        if cfg is None or cfg.integer_stretched_kernel_radius > self._radius_bound:
            return False
        self._set_config(cfg, fx.calculate_ratio(input_rate, output_rate))
        return True

    # ------------------------------------------------------------------
    # Device-side staging ops (jitted; fill/shift are dynamic scalars).
    @staticmethod
    @partial(jax.jit, static_argnames=("total_lanes",))
    def _dev_stage(staging, chunk, fill, total_lanes):
        b, n, c = chunk.shape
        rows = chunk.astype(jnp.int32).transpose(1, 0, 2).reshape(n, b * c)
        rows = jnp.pad(rows, ((0, 0), (0, total_lanes - b * c)))
        return jax.lax.dynamic_update_slice(staging, rows, (fill, 0))

    @staticmethod
    @jax.jit
    def _dev_shift(staging, shift, keep):
        rolled = jnp.roll(staging, -shift, axis=0)
        row = jnp.arange(staging.shape[0], dtype=jnp.int32)[:, None]
        return jnp.where(row < keep, rolled, 0)

    @staticmethod
    @jax.jit
    def _dev_zero_rows(staging, fill, n):
        row = jnp.arange(staging.shape[0], dtype=jnp.int32)[:, None]
        return jnp.where((row >= fill) & (row < fill + n), 0, staging)

    # ------------------------------------------------------------------
    def _natural_count(self, total_frames: int) -> int:
        num = ((total_frames - self.position_integer) << 16) - self.position_fractional
        return 0 if num <= 0 else -(-num // self.increment)

    def _launch_specs(self, n_out: int) -> list:
        """[(tile, state, plan), ...]: the launches producing frames
        [0, n_out) from the staging buffer, in frame order.

        Frame-tiled into at most ops.resample.MAX_LAUNCH_FRAMES-frame launches (device
        positions are int32-exact only below 2^15 frames; p0/f0 advance
        host-side in exact Python ints between tiles, like
        LowLevelResampler._compute_frames), and within the launch route's
        window-gather bound. Plans are the static halves of
        ops.resample.multi_resample launches, so a MixedStreamFarm can fuse
        every group's launches into ONE device program.
        """
        # Launch at the CURRENT ratio's tap width, not the farm's reserved
        # bound: kernel values past a frame's tap count are masked to zero,
        # so any launch width >= the current one is bit-exact, and the MAC
        # volume scales with the launch width.
        taps = min(self._max_taps,
                   fx.round_up(2 * self.config.integer_stretched_kernel_radius, 8))
        step = lanes_launch_frames(taps, self._lanes)
        # Staging keeps a fixed radius_bound-row left halo; the C window
        # contract (clownresampler.h:725-733) puts the buffer origin only
        # `radius` rows before the data, so shift launch positions by the
        # difference when the current radius is narrower than the bound.
        halo_shift = self._radius_bound - self.config.integer_stretched_kernel_radius
        specs = []
        done = 0
        while done < n_out:
            tile = min(n_out - done, step)
            t = self.position_fractional + done * self.increment
            p0 = self.position_integer + (t >> 16) + halo_shift
            state = make_device_state(p0, t & 0xFFFF, self.config, self.increment)
            plan = plan_launch(taps, fx.round_up(tile, 8), self.clamp_s16)
            specs.append((tile, state, plan))
            done += tile
        return specs

    def _spec_input(self):
        """The staging buffer as a device array (host staging uploads it)."""
        return self._staging if self._device_staging else jnp.asarray(self._staging)

    @staticmethod
    def _collect_parts(specs: list, outs) -> np.ndarray:
        parts = [np.asarray(o)[:tile] for (tile, _, _), o in zip(specs, outs)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def _launch(self, n_out: int) -> np.ndarray:
        """Run every launch of this emit over the staging buffer as one
        device program."""
        specs = self._launch_specs(n_out)
        x = self._spec_input()
        outs = multi_resample(
            self._table,
            (x,) * len(specs),
            tuple(state for _, state, _ in specs),
            tuple(plan for _, _, plan in specs),
        )
        return self._collect_parts(specs, outs)

    def _emit(self, total_frames: int) -> np.ndarray:
        """Produce every frame available against `total_frames` of data, then
        slide the staging window (LowLevel position carry, 1063-1068)."""
        n_out = self._natural_count(total_frames)
        lanes_out = self._launch(n_out) if n_out > 0 else None
        return self._finish_emit(total_frames, n_out, lanes_out)

    def _finish_emit(
        self, total_frames: int, n_out: int, lanes_out: Optional[np.ndarray],
        defer_slide: bool = False,
    ) -> np.ndarray:
        """De-interleave launched lanes, advance the phase, slide the staging
        window. Split from _emit so MixedStreamFarm can run every group's
        launches as one combined device program between the two halves;
        defer_slide additionally parks the device shift in _pending_slide for
        the caller to fuse across groups."""
        out_dtype = np.int16 if self.clamp_s16 else np.int32
        if n_out > 0:
            if self.clamp_s16:
                # int16 lanes: plain numpy de-interleave (the native engine's
                # unstage is int32-specific).
                bc = self.n_streams * self.channels
                result = np.ascontiguousarray(
                    lanes_out[:, :bc]
                    .reshape(-1, self.n_streams, self.channels)
                    .transpose(1, 0, 2)
                )
            else:
                result = native.unstage_output(lanes_out, self.n_streams, self.channels)
        else:
            result = np.zeros((self.n_streams, 0, self.channels), out_dtype)

        t = self.position_fractional + n_out * self.increment
        self.position_integer += t >> 16
        self.position_fractional = t & 0xFFFF
        consumed = min(self.position_integer, total_frames)
        self.position_integer -= consumed
        # Slide out consumed frames; retain everything after them (incl. halo).
        keep = self._fill - consumed
        if consumed:
            if self._device_staging and defer_slide:
                # MixedStreamFarm fuses every group's slide into ONE device
                # program after distributing results (see _pending_slide).
                self._pending_slide = (consumed, keep)
            elif self._device_staging:
                self._staging = self._dev_shift(
                    self._staging, jnp.int32(consumed), jnp.int32(keep)
                )
            else:
                native.shift_rows(self._staging, keep, consumed)
        self._fill = keep
        return result

    def _stage_prepare(self, chunk: np.ndarray) -> np.ndarray:
        """Validate a chunk against the staging contract (host-side half of
        _stage, split out so MixedStreamFarm can fuse every group's device
        staging op into one program)."""
        chunk = np.ascontiguousarray(chunk, dtype=np.int16)
        b, n, c = chunk.shape
        assert b == self.n_streams and c == self.channels and n <= self.chunk_frames
        if self._fill + n > self._capacity:
            raise ValueError("staging overflow: feed chunks of at most chunk_frames")
        return chunk

    def _stage_commit(self, n: int) -> int:
        """Advance the fill cursor after the staging write; returns the
        consumable frame count (the last `radius` data rows stay held back
        until more data or flush arrives — the high-level buffer's early
        `input_buffer_end`, 1154)."""
        self._fill += n
        return self._fill - 2 * self._radius_bound

    def _stage(self, chunk: np.ndarray) -> int:
        """Stage one input chunk; returns the consumable frame count."""
        chunk = self._stage_prepare(chunk)
        if self._device_staging:
            self._staging = self._dev_stage(
                self._staging, jnp.asarray(chunk), jnp.int32(self._fill),
                total_lanes=self._lanes,
            )
        else:
            native.stage_chunk(chunk, self._staging, self._fill)
        return self._stage_commit(chunk.shape[1])

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (n_streams, n, channels) int16; returns (n_streams, m, channels)
        wide int32 output frames (m varies with phase, ~n*out_rate/in_rate)."""
        total = self._stage(chunk)
        out_dtype = np.int16 if self.clamp_s16 else np.int32
        return self._emit(total) if total > 0 else np.zeros(
            (self.n_streams, 0, self.channels), out_dtype
        )

    def flush(self) -> np.ndarray:
        """Feed `radius` zero frames and drain (ResampleEnd, 1242-1250)."""
        r = self._radius_bound
        if self._device_staging:
            self._staging = self._dev_zero_rows(
                self._staging, jnp.int32(self._fill), jnp.int32(r)
            )
        else:
            native.zero_rows(self._staging, self._fill, r)
        self._fill += r
        total = self._fill - 2 * self._radius_bound
        return self._emit(max(total, 0))


class MixedStreamFarm:
    """Streams at heterogeneous ratios, grouped per-ratio into uniform farms.

    Streams share nothing (SURVEY.md section 2: no cross-stream communication
    exists to replicate), so a mixed fleet decomposes exactly into one
    UniformStreamFarm per distinct (rates, lpf) triple — and every group's
    launches for a chunk are FUSED into one device program
    (ops.resample.multi_resample), so G groups pay one program dispatch per
    chunk, not G. This is the BASELINE.json config-5 "mixed-ratio transcode
    farm" as an API.

    ``specs`` is a list of per-stream (input_rate, output_rate[, lpf]) tuples.
    ``process`` takes/returns per-stream lists (outputs differ in length per
    ratio). Per-stream re-rating is :meth:`adjust_stream` (the re-rated
    stream splits into its own phase-carrying group); whole-fleet re-rating
    of a uniform group is its farm's ``adjust``.
    """

    def __init__(self, specs, channels: int, chunk_frames: int = 4096,
                 model: KernelModel = DEFAULT_MODEL,
                 max_radius: Optional[int] = None, clamp_s16: bool = False):
        self.channels = channels
        self.n_streams = len(specs)
        self.chunk_frames = chunk_frames
        self.model = model
        self.max_radius = max_radius
        self.clamp_s16 = clamp_s16
        # [(farm, members)]: members[j] is the stream id occupying the farm's
        # lane slot j, or None for a slot vacated by adjust_stream (fed zeros,
        # its output discarded). Groups are identified by position, not ratio:
        # a re-rated stream carries its own phase, so two groups may share a
        # ratio but differ in phase lineage.
        self._groups: list[list] = []
        norm = []
        for spec in specs:
            in_rate, out_rate = spec[0], spec[1]
            lpf = spec[2] if len(spec) > 2 else max(in_rate, out_rate)
            norm.append((in_rate, out_rate, lpf))
        by_key: dict[tuple, int] = {}
        for i, key in enumerate(norm):
            if key not in by_key:
                farm = self._make_group_farm(
                    sum(1 for k in norm if k == key), key,
                    max_radius=max_radius,
                )
                by_key[key] = len(self._groups)
                self._groups.append([farm, []])
            self._groups[by_key[key]][1].append(i)

    def _make_group_farm(self, n_streams: int, rates: tuple,
                         max_radius: Optional[int] = None) -> UniformStreamFarm:
        """Group-farm factory (ShardedMixedStreamFarm overrides this to build
        mesh-sharded groups)."""
        return UniformStreamFarm(
            n_streams, self.channels, *rates,
            chunk_frames=self.chunk_frames, model=self.model,
            max_radius=max_radius, clamp_s16=self.clamp_s16,
        )

    def _run_combined_launch(self, table, xs, states, plans) -> list:
        """Run every group's launches as ONE device program
        (ShardedMixedStreamFarm overrides this with a shard_map version)."""
        return list(multi_resample(table, tuple(xs), tuple(states), tuple(plans)))

    def adjust_stream(self, i: int, input_rate: int, output_rate: int,
                      low_pass_rate: Optional[int] = None) -> bool:
        """Re-rate ONE stream mid-stream (the reference's per-stream Adjust,
        clownresampler.h:1052-1056, at batch scale): position carries over,
        only the increment/stretching change; every other stream is
        untouched.

        A stream's phase is its own after an adjust, so it can no longer
        share a uniform launch with its old group: the stream is split into
        its own single-stream farm seeded with its current phase and staged
        samples, and its old lane slot is retired (fed zeros). Subsequent
        adjusts on the same stream are then in-place on its private farm.
        Fails (returns False, nothing changes) if the new ratio is
        unsupported or its radius exceeds the construction-time bound, like
        HighLevel_Adjust (clownresampler.h:1183-1209)."""
        low_pass_rate = (low_pass_rate if low_pass_rate is not None
                         else max(input_rate, output_rate))
        for group in self._groups:
            farm, members = group
            if i in members:
                break
        else:
            raise IndexError(f"no stream {i}")
        if sum(1 for m in members if m is not None) == 1:
            return farm.adjust(input_rate, output_rate, low_pass_rate)
        # Validate against the source farm's reserved radius bound BEFORE any
        # surgery (transactional, like HighLevel_Adjust's backup/rollback).
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=farm.model.radius, resolution=farm.model.resolution)
        if cfg is None or cfg.integer_stretched_kernel_radius > farm._radius_bound:
            return False
        j = members.index(i)
        # Same radius bound, chunk size and model: the same staging geometry.
        solo = self._make_group_farm(
            1, (input_rate, output_rate, low_pass_rate),
            max_radius=farm._radius_bound,
        )
        assert solo._capacity == farm._capacity
        solo.position_integer = farm.position_integer
        solo.position_fractional = farm.position_fractional
        solo._fill = farm._fill
        lane_lo = j * self.channels
        if farm._device_staging and solo._device_staging:
            # Migrate the stream's staged lanes entirely on device: one jitted
            # slice+scatter program, no host round-trip mid-stream.
            migrated = self._dev_migrate_lanes(
                farm._staging, jnp.int32(lane_lo), width=self.channels,
                dst_lanes=solo._lanes,
            )
            sharding = getattr(solo, "_sharding", None)  # mesh-sharded solo
            if sharding is not None:
                migrated = jax.device_put(migrated, sharding)
            solo._staging = migrated
        else:
            solo._staging[:, : self.channels] = farm._staging[
                :, lane_lo : lane_lo + self.channels]
        members[j] = None
        self._groups.append([solo, [i]])
        return True

    @staticmethod
    @partial(jax.jit, static_argnames=("width", "dst_lanes"))
    def _dev_migrate_lanes(src, lane_lo, width, dst_lanes):
        """A solo farm's staging buffer: lanes [lane_lo, lane_lo + width) of
        the source farm's buffer, entirely on device (rows verbatim —
        capacities match by construction; remaining lanes are zero)."""
        cols = jax.lax.dynamic_slice_in_dim(src, lane_lo, width, axis=1)
        return jnp.pad(cols, ((0, 0), (0, dst_lanes - width)))

    # Fused per-group device staging ops: one compiled program stages (or
    # slides) EVERY group's buffer, instead of one dispatch per group per
    # chunk (the same argument as the fused launches).
    @staticmethod
    @partial(jax.jit, static_argnames=("lanes_list",))
    def _dev_stage_groups(stagings, chunks, fills, lanes_list):
        return tuple(
            UniformStreamFarm._dev_stage(st, ch, f, total_lanes=tl)
            for st, ch, f, tl in zip(stagings, chunks, fills, lanes_list)
        )

    @staticmethod
    @jax.jit
    def _dev_shift_groups(stagings, shifts, keeps):
        return tuple(
            UniformStreamFarm._dev_shift(st, sh, k)
            for st, sh, k in zip(stagings, shifts, keeps)
        )

    def process(self, chunks: list) -> list:
        """chunks[i]: (n, channels) int16 for stream i (equal n per call).
        Returns outputs[i]: (m_i, channels) int32 (m varies per ratio).

        The whole chunk cycle runs as THREE device programs regardless of
        group count: one fused staging write, one fused multi-group launch,
        one fused staging slide.
        """
        # Stage every group's chunk (one fused program when device-resident),
        # collect each group's launch specs. Vacated lane slots (None
        # members, retired by adjust_stream) are fed zeros.
        live = [i for _, members in self._groups for i in members if i is not None]
        zeros = np.zeros_like(np.asarray(chunks[live[0]], np.int16))
        staged = []  # (farm, members, batch)
        for farm, members in self._groups:
            batch = farm._stage_prepare(
                np.stack([
                    zeros if i is None else np.asarray(chunks[i], np.int16)
                    for i in members
                ])
            )
            staged.append((farm, members, batch))
        dev_farms = [t for t in staged if t[0]._device_staging]
        if dev_farms:
            new_stagings = self._dev_stage_groups(
                tuple(f._staging for f, _, _ in dev_farms),
                tuple(jnp.asarray(b) for _, _, b in dev_farms),
                tuple(jnp.int32(f._fill) for f, _, _ in dev_farms),
                lanes_list=tuple(f._lanes for f, _, _ in dev_farms),
            )
            for (f, _, _), st in zip(dev_farms, new_stagings):
                f._staging = st
        pending = []  # (farm, members, total, n_out, specs)
        for farm, members, batch in staged:
            if not farm._device_staging:
                native.stage_chunk(batch, farm._staging, farm._fill)
            total = farm._stage_commit(batch.shape[1])
            n_out = farm._natural_count(total) if total > 0 else 0
            specs = farm._launch_specs(n_out) if n_out > 0 else []
            pending.append((farm, members, total, n_out, specs))

        # One combined launch across every group's specs.
        xs, states, plans = [], [], []
        for farm, _, _, _, specs in pending:
            if specs:
                x = farm._spec_input()
                for _, state, plan in specs:
                    xs.append(x)
                    states.append(state)
                    plans.append(plan)
        outs = (self._run_combined_launch(pending[0][0]._table, xs, states, plans)
                if xs else [])

        # Distribute results and run each group's bookkeeping; device slides
        # are parked (defer_slide) and fused into one program at the end.
        outputs: list = [None] * self.n_streams
        cursor = 0
        for farm, members, total, n_out, specs in pending:
            if n_out > 0:
                lanes_out = farm._collect_parts(
                    specs, outs[cursor : cursor + len(specs)])
                cursor += len(specs)
            else:
                lanes_out = None
            if total > 0:
                out = farm._finish_emit(total, n_out, lanes_out, defer_slide=True)
            else:
                dtype = np.int16 if farm.clamp_s16 else np.int32
                out = np.zeros((farm.n_streams, 0, farm.channels), dtype)
            for j, i in enumerate(members):
                if i is not None:
                    outputs[i] = out[j]
        sliding = [f for f, *_ in pending if f._pending_slide is not None]
        if sliding:
            new_stagings = self._dev_shift_groups(
                tuple(f._staging for f in sliding),
                tuple(jnp.int32(f._pending_slide[0]) for f in sliding),
                tuple(jnp.int32(f._pending_slide[1]) for f in sliding),
            )
            for f, st in zip(sliding, new_stagings):
                f._staging = st
                f._pending_slide = None
        return outputs

    def flush(self) -> list:
        outputs: list = [None] * self.n_streams
        for farm, members in self._groups:
            out = farm.flush()
            for j, i in enumerate(members):
                if i is not None:
                    outputs[i] = out[j]
        return outputs
