#!/usr/bin/env python3
"""Batched transcode farm: N copies of a file through one device launch.

The capability the scalar reference has no analogue for: thousands of
independent streams resampled in parallel as lanes of one launch
(BASELINE.json config 5 shape).

Usage: python examples/transcode_farm.py in.wav out_rate [n_streams]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

from clownresampler_tpu import UniformStreamFarm, platform
from clownresampler_tpu.utils.audio_io import read_wav

CHUNK = 4096


def main() -> None:
    platform.enable_compile_cache()
    in_path, out_rate = sys.argv[1], int(sys.argv[2])
    n_streams = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    frames, in_rate = read_wav(in_path)
    channels = frames.shape[1]

    data = np.broadcast_to(frames, (n_streams, *frames.shape)).copy()
    farm = UniformStreamFarm(n_streams, channels, in_rate, out_rate)

    t0 = time.perf_counter()
    produced = 0
    for off in range(0, frames.shape[0], CHUNK):
        out = farm.process(data[:, off : off + CHUNK])
        produced += out.shape[1] * n_streams * channels
    out = farm.flush()
    produced += out.shape[1] * n_streams * channels
    dt = time.perf_counter() - t0
    print(
        f"{n_streams} streams x {frames.shape[0]} frames @ {in_rate} -> {out_rate} Hz: "
        f"{produced / 1e6:.1f} Msamples in {dt:.2f}s "
        f"({produced / dt / 1e6:.0f} Msamples/s end-to-end incl. host staging)"
    )


if __name__ == "__main__":
    main()
