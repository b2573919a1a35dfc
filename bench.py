"""Headline throughput on an NVIDIA GPU: 1024 stereo streams, 48k->44.1k.

The served path end to end: int16 chunks on the host go through
``UniformStreamFarm.process`` (host-to-device copy, device staging, one
launch, device-to-host copy, de-interleave) and come back as int32 samples
per stream. After warm-up, one window of WINDOW consecutive process() calls
is timed on the host clock: the rate is the window's output samples over
its seconds, stalls included. Per-call median and quartiles are printed
beside it.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N, ...}

vs_baseline divides by the C reference's single-core rate for the same
conversion (BASELINE.md: 74.9 Msamples/s). Refuses to run anywhere but a GPU.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

STREAMS, CHANNELS, CHUNK = 1024, 2, 4096
WARMUP, WINDOW = 3, 20
C_REFERENCE_MSAMPLES = 74.9


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU only; JAX found {jax.devices()}",
              file=sys.stderr)
        return 2
    from clownresampler_tpu import platform
    from clownresampler_tpu.farm import UniformStreamFarm

    platform.enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    chunk = rng.integers(-32768, 32768, size=(STREAMS, CHUNK, CHANNELS), dtype=np.int16)
    farm = UniformStreamFarm(STREAMS, CHANNELS, 48000, 44100, chunk_frames=CHUNK)
    for _ in range(WARMUP):
        farm.process(chunk)
    samples, per_call = 0, []
    start = time.perf_counter()
    for _ in range(WINDOW):
        t0 = time.perf_counter()
        samples += farm.process(chunk).size     # host numpy: the call is done
        per_call.append(time.perf_counter() - t0)
    window = time.perf_counter() - start
    msps = samples / window / 1e6
    q1, med, q3 = (1e3 * q for q in statistics.quantiles(per_call, n=4))
    print(json.dumps({
        "metric": "UniformStreamFarm.process 1024 x stereo 48k->44.1k, 4096-frame chunks",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / C_REFERENCE_MSAMPLES,
        "window_calls": WINDOW,
        "window_s": window,
        "per_call_ms": {"median": med, "q1": q1, "q3": q3},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
