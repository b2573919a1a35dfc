#!/usr/bin/env python3
"""Multi-device transcode farm + per-stream pitch bends.

Demonstrates the two batch-scale capabilities the scalar reference has no
analogue for:

* ``ShardedStreamFarm`` — the transcode farm with its lane (stream x channel)
  axis sharded over a ``jax.sharding`` mesh: each device runs the launch on
  its own stream slice, zero collectives (streams share nothing — SURVEY.md
  section 2). It runs on a virtual 8-device CPU mesh so the example works
  anywhere; CLOWNRESAMPLER_REAL_DEVICES=1 uses the machine's own devices
  (8 GPUs).
* ``MixedStreamFarm.adjust_stream`` — the reference's per-stream Adjust
  (clownresampler.h:1052-1056) at batch scale: re-rate ONE stream mid-stream
  (its position carries over), leaving the rest of the fleet untouched.

Usage: python examples/multichip_farm.py [n_streams]
"""

import os
import sys

# Force a virtual 8-device mesh BEFORE jax initialises (same recipe as
# tests/conftest.py; harmless when real multi-device hardware is attached).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, ".")

import numpy as np


def main() -> None:
    n_devices = 8
    if not os.environ.get("CLOWNRESAMPLER_REAL_DEVICES"):
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    from clownresampler_tpu import platform
    from clownresampler_tpu.farm import MixedStreamFarm
    from clownresampler_tpu.parallel import ShardedStreamFarm, make_mesh

    platform.enable_compile_cache()
    n_streams = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    rng = np.random.default_rng(0)
    chunk = 512
    data = rng.integers(-32768, 32768, (n_streams, 4 * chunk, 2)).astype(np.int16)

    # --- sharded farm: one fleet over all devices ---------------------------
    mesh = make_mesh(dp=n_devices, sp=1, devices=jax.devices()[:n_devices])
    farm = ShardedStreamFarm(mesh, n_streams, 2, 48000, 44100,
                             chunk_frames=chunk)
    total = 0
    for k in range(4):
        out = farm.process(data[:, k * chunk : (k + 1) * chunk])
        total += out.shape[1]
    total += farm.flush().shape[1]
    print(f"sharded farm: {n_streams} streams x {4 * chunk} frames -> "
          f"{total} frames/stream over {n_devices} devices "
          f"({mesh.shape} mesh, backend={jax.default_backend()})")

    # --- per-stream pitch bend on a mixed fleet -----------------------------
    mixed = MixedStreamFarm([(48000, 44100)] * 4, 2, chunk_frames=chunk,
                            max_radius=8)
    small = data[:4]
    a = mixed.process([small[i, :chunk] for i in range(4)])
    assert mixed.adjust_stream(2, 96000, 48000)    # stream 2 drops an octave
    b = mixed.process([small[i, chunk : 2 * chunk] for i in range(4)])
    tails = mixed.flush()
    lens = [a[i].shape[0] + b[i].shape[0] + tails[i].shape[0] for i in range(4)]
    print(f"per-stream adjust: output frame counts {lens} "
          f"(stream 2 re-rated mid-stream; others untouched)")
    assert lens[2] < lens[0]

    # --- mixed-ratio fleet over the mesh ------------------------------------
    # Two ratio groups, each lane-sharded over dp; every group's kernel runs
    # inside ONE shard-mapped program per chunk.
    from clownresampler_tpu.parallel import ShardedMixedStreamFarm

    half = n_streams // 2
    specs = [(48000, 44100)] * half + [(96000, 48000)] * (n_streams - half)
    shmixed = ShardedMixedStreamFarm(mesh, specs, 2, chunk_frames=chunk)
    outs = shmixed.process([data[i, :chunk] for i in range(n_streams)])
    tails = shmixed.flush()
    print(f"sharded mixed farm: {half}+{n_streams - half} streams in 2 ratio "
          f"groups over {n_devices} devices -> "
          f"{outs[0].shape[0] + tails[0].shape[0]} / "
          f"{outs[-1].shape[0] + tails[-1].shape[0]} frames/stream")


if __name__ == "__main__":
    main()
