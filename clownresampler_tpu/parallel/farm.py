"""Mesh-sharded transcode farm: the multi-device batch path.

``ShardedStreamFarm`` is ``farm.UniformStreamFarm`` with the lane
(stream x channel) axis sharded over a device mesh's ``dp`` axis. Streams
share nothing (SURVEY.md section 2: the reference is a scalar, single-stream
library; there is no cross-stream communication to replicate), so this is
pure data parallelism with ZERO collectives:

* the staging buffer lives sharded on the mesh (rows replicated, lanes
  split); the chunk-cycle device ops (stage write, launch, slide) partition
  along the lane axis, so XLA inserts only the initial host-chunk scatter;
* the launch runs under ``shard_map``: each device executes the launch
  (ops/resample.py) on its own lane shard with the replicated scalar phase
  state and LUT;
* all host bookkeeping (positions, halo slide, natural counts) is inherited
  unchanged, so outputs are bit-exact vs the single-device farm and
  transitively vs the C reference per stream (tests/test_sharded_farm.py).

The per-stream phase state is shared across the fleet (uniform ratio), so
``adjust`` (pitch bend) works exactly as on the single-device farm.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from clownresampler_tpu.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu.models import DEFAULT_MODEL, KernelModel
from clownresampler_tpu.ops.resample import multi_resample


def _sharded_launch(mesh: Mesh, plans: tuple, n_inputs: int):
    """One jitted shard_map program running every launch of ``plans`` on
    each device's lane shard of its input."""

    def per_shard(table, xs_local, sts):
        return multi_resample(table, xs_local, sts, plans)

    state_spec = P()  # phase states and the LUT are replicated
    return jax.jit(shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), tuple(P(None, "dp") for _ in range(n_inputs)), state_spec),
        out_specs=tuple(P(None, "dp") for _ in plans),
        check_vma=False,
    ))


class ShardedStreamFarm(UniformStreamFarm):
    """UniformStreamFarm whose lanes shard over ``mesh``'s ``dp`` axis."""

    def __init__(
        self,
        mesh: Mesh,
        n_streams: int,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: Optional[int] = None,
        chunk_frames: int = 4096,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        clamp_s16: bool = False,
    ):
        self.mesh = mesh
        self._dp = mesh.shape["dp"]
        super().__init__(
            n_streams, channels, input_rate, output_rate, low_pass_rate,
            chunk_frames=chunk_frames, model=model, max_radius=max_radius,
            clamp_s16=clamp_s16,
            # every device holds an equal lane shard
            lane_multiple=self._dp,
            # the staging buffer lives sharded on the mesh on every backend
            device_staging=True,
        )
        self._sharding = NamedSharding(mesh, P(None, "dp"))
        self._staging = jax.device_put(self._staging, self._sharding)
        self._launch_cache: dict = {}

    def _launch(self, n_out: int):
        """Shard-mapped analogue of UniformStreamFarm._launch: every launch
        runs per device on that device's lane shard of the staging buffer,
        fused into one program."""
        specs = self._launch_specs(n_out)
        plans = tuple(plan for _, _, plan in specs)
        fn = self._launch_cache.get(plans)
        if fn is None:
            fn = self._launch_cache[plans] = _sharded_launch(
                self.mesh, plans, len(plans))
        outs = fn(self._table, (self._staging,) * len(plans),
                  tuple(state for _, state, _ in specs))
        return self._collect_parts(specs, outs)


class ShardedMixedStreamFarm(MixedStreamFarm):
    """MixedStreamFarm whose ratio groups each shard over ``mesh``'s ``dp``
    axis: per-ratio-group lane sharding, with every group's launches fused
    into ONE shard-mapped device program per chunk.

    Streams still share nothing (SURVEY.md section 2: no cross-stream
    communication), so the only mesh interaction is the lane partition of
    each group's staging buffer — zero collectives. Each group is a
    ShardedStreamFarm, so per-group lane counts pad to a multiple of dp;
    ``adjust_stream`` migrates a stream into its own sharded solo farm
    exactly as on the single-device mixed farm (clownresampler.h:1052-1056
    per stream, at multi-device batch scale). Bit-exact vs MixedStreamFarm
    per stream (tests/test_sharded_farm.py).
    """

    def __init__(self, mesh: Mesh, specs, channels: int,
                 chunk_frames: int = 4096, model: KernelModel = DEFAULT_MODEL,
                 max_radius: Optional[int] = None, clamp_s16: bool = False):
        self.mesh = mesh
        self._mixed_launch_cache: dict = {}
        super().__init__(specs, channels, chunk_frames=chunk_frames,
                         model=model, max_radius=max_radius,
                         clamp_s16=clamp_s16)

    def _make_group_farm(self, n_streams, rates, max_radius=None):
        return ShardedStreamFarm(
            self.mesh, n_streams, self.channels, *rates,
            chunk_frames=self.chunk_frames, model=self.model,
            max_radius=max_radius, clamp_s16=self.clamp_s16,
        )

    def _run_combined_launch(self, table, xs, states, plans):
        """One shard-mapped program running EVERY group's launches on each
        device's lane shard of that group's staging buffer."""
        plans = tuple(plans)
        fn = self._mixed_launch_cache.get(plans)
        if fn is None:
            fn = self._mixed_launch_cache[plans] = _sharded_launch(
                self.mesh, plans, len(plans))
        return list(fn(table, tuple(xs), tuple(states)))
