"""State checkpoint/resume for every stateful API.

The reference's state is two POD structs that are trivially copyable, which it
exploits for transactional rollback (clownresampler.h:1186-1191) and which
users exploit for save/restore. Here the equivalents are explicit: every
stateful object serialises to a plain dict of ints/arrays (JSON- and
npz-friendly) and restores exactly — resuming a stream mid-flight produces
bit-identical continuation. A snapshot's ``interpret`` key, which older
versions wrote, is ignored on load.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax.numpy as jnp

from clownresampler_tpu.configure import Configuration
from clownresampler_tpu.farm import UniformStreamFarm
from clownresampler_tpu.highlevel import HighLevelResampler
from clownresampler_tpu.lowlevel import LowLevelResampler
from clownresampler_tpu.models import KernelModel


def _config_dict(cfg: Configuration) -> dict:
    return {
        "stretched_kernel_radius": cfg.stretched_kernel_radius,
        "integer_stretched_kernel_radius": cfg.integer_stretched_kernel_radius,
        "stretched_kernel_radius_delta": cfg.stretched_kernel_radius_delta,
        "kernel_step_size": cfg.kernel_step_size,
        "radius": cfg.radius,
        "resolution": cfg.resolution,
    }


def _config_from(d: dict) -> Configuration:
    return Configuration(**d)


def save_lowlevel(rs: LowLevelResampler) -> dict[str, Any]:
    return {
        "kind": "lowlevel",
        "channels": rs.channels,
        "position_integer": rs.position_integer,
        "position_fractional": rs.position_fractional,
        "increment": rs.increment,
        "config": _config_dict(rs.config),
        "max_taps": rs._max_taps,
        "model_radius": rs.model.radius,
        "model_resolution": rs.model.resolution,
    }


def load_lowlevel(d: dict[str, Any]) -> LowLevelResampler:
    assert d["kind"] == "lowlevel"
    rs = LowLevelResampler(
        channels=d["channels"],
        model=KernelModel(d["model_radius"], d["model_resolution"]),
    )
    rs.position_integer = d["position_integer"]
    rs.position_fractional = d["position_fractional"]
    rs.increment = d["increment"]
    rs.config = _config_from(d["config"])
    rs._max_taps = d["max_taps"]
    return rs


def save_highlevel(rs: HighLevelResampler) -> dict[str, Any]:
    return {
        "kind": "highlevel",
        "low_level": save_lowlevel(rs.low_level),
        "input_buffer": rs.input_buffer.copy(),
        "input_buffer_start": rs.input_buffer_start,
        "input_buffer_end": rs.input_buffer_end,
        "maximum_integer_stretched_kernel_radius": rs.maximum_integer_stretched_kernel_radius,
        "leading_padding_frames_needed": rs.leading_padding_frames_needed,
        "trailing_padding_frames_remaining": rs.trailing_padding_frames_remaining,
        "buffer_total_samples": rs.buffer_total_samples,
    }


def load_highlevel(d: dict[str, Any]) -> HighLevelResampler:
    assert d["kind"] == "highlevel"
    return HighLevelResampler(
        low_level=load_lowlevel(d["low_level"]),
        input_buffer=np.array(d["input_buffer"], dtype=np.int16),
        input_buffer_start=d["input_buffer_start"],
        input_buffer_end=d["input_buffer_end"],
        maximum_integer_stretched_kernel_radius=d["maximum_integer_stretched_kernel_radius"],
        leading_padding_frames_needed=d["leading_padding_frames_needed"],
        trailing_padding_frames_remaining=d["trailing_padding_frames_remaining"],
        buffer_total_samples=d["buffer_total_samples"],
    )


def save_farm(farm: UniformStreamFarm) -> dict[str, Any]:
    return {
        "kind": "farm",
        "n_streams": farm.n_streams,
        "channels": farm.channels,
        "chunk_frames": farm.chunk_frames,
        "position_integer": farm.position_integer,
        "position_fractional": farm.position_fractional,
        "increment": farm.increment,
        "config": _config_dict(farm.config),
        "radius_bound": farm._radius_bound,
        "staging": np.array(farm._staging),
        "fill": farm._fill,
        "device_staging": farm._device_staging,
        "clamp_s16": farm.clamp_s16,
        "model_radius": farm.model.radius,
        "model_resolution": farm.model.resolution,
    }


def load_farm(d: dict[str, Any], mesh=None) -> UniformStreamFarm:
    """Restore a farm. Pass ``mesh`` to restore as a ShardedStreamFarm
    (lane-sharded over the mesh's dp axis); the lane count must tile it."""
    assert d["kind"] == "farm"
    farm = UniformStreamFarm.__new__(UniformStreamFarm)
    farm.n_streams = d["n_streams"]
    farm.channels = d["channels"]
    farm.chunk_frames = d["chunk_frames"]
    farm.clamp_s16 = d.get("clamp_s16", False)
    farm.model = KernelModel(d["model_radius"], d["model_resolution"])
    farm._table = jnp.asarray(farm.model.table())
    farm.position_integer = d["position_integer"]
    farm.position_fractional = d["position_fractional"]
    farm.increment = d["increment"]
    farm.config = _config_from(d["config"])
    farm._radius_bound = d["radius_bound"]
    farm._max_taps = -(-2 * farm._radius_bound // 8) * 8
    farm._device_staging = d.get("device_staging", False)
    staging = np.array(d["staging"], dtype=np.int32)
    farm._capacity = staging.shape[0]
    farm._lanes = staging.shape[1]
    farm._staging = jnp.asarray(staging) if farm._device_staging else staging
    farm._fill = d["fill"]
    farm._pending_slide = None
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from clownresampler_tpu.parallel.farm import ShardedStreamFarm

        sh = ShardedStreamFarm.__new__(ShardedStreamFarm)
        sh.__dict__.update(farm.__dict__)
        sh.mesh = mesh
        sh._dp = mesh.shape["dp"]
        if sh._lanes % sh._dp != 0:
            raise ValueError(
                f"snapshot has {sh._lanes} lanes, which does not split into "
                f"equal shards over the {sh._dp}-device dp axis; restore "
                f"without a mesh or use a compatible mesh"
            )
        sh._device_staging = True
        sh._sharding = NamedSharding(mesh, P(None, "dp"))
        sh._staging = jax.device_put(jnp.asarray(staging), sh._sharding)
        sh._launch_cache = {}
        return sh
    return farm


def save_mixed_farm(farm) -> dict[str, Any]:
    """Serialise a MixedStreamFarm: each group's uniform farm plus its
    member slots (None = lane slot vacated by adjust_stream)."""
    return {
        "kind": "mixed_farm",
        "n_streams": farm.n_streams,
        "channels": farm.channels,
        "chunk_frames": farm.chunk_frames,
        "max_radius": farm.max_radius,
        "clamp_s16": farm.clamp_s16,
        "model_radius": farm.model.radius,
        "model_resolution": farm.model.resolution,
        "groups": [
            {"farm": save_farm(f), "members": list(members)}
            for f, members in farm._groups
        ],
    }


def load_mixed_farm(d: dict[str, Any], mesh=None):
    """Restore a mixed farm. Pass ``mesh`` to restore as a
    ShardedMixedStreamFarm (every group lane-sharded over the mesh's dp
    axis); each group's lane count must tile it, like load_farm."""
    assert d["kind"] == "mixed_farm"
    from clownresampler_tpu.farm import MixedStreamFarm

    if mesh is None:
        farm = MixedStreamFarm.__new__(MixedStreamFarm)
    else:
        from clownresampler_tpu.parallel.farm import ShardedMixedStreamFarm

        farm = ShardedMixedStreamFarm.__new__(ShardedMixedStreamFarm)
        farm.mesh = mesh
        farm._mixed_launch_cache = {}
    farm.n_streams = d["n_streams"]
    farm.channels = d["channels"]
    farm.chunk_frames = d["chunk_frames"]
    farm.max_radius = d["max_radius"]
    farm.clamp_s16 = d.get("clamp_s16", False)
    farm.model = KernelModel(d["model_radius"], d["model_resolution"])
    farm._groups = [
        [load_farm(g["farm"], mesh=mesh), list(g["members"])] for g in d["groups"]
    ]
    return farm
