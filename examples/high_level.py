#!/usr/bin/env python3
"""Streaming resampling via the high-level API.

Mirrors the reference's examples/high-level.c (embedded clownresampler.h:251-425):
pull input through a callback in chunks, let the library handle edge padding
and the staging-buffer halo, flush the tail at end of stream.

Usage: python examples/high_level.py in.wav out.wav <out_rate> [lpf_rate]
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from clownresampler_tpu import HighLevelResampler, platform
from clownresampler_tpu.utils.audio_io import clamp_s16, read_wav, write_wav

CHUNK = 2048  # frames per input-callback delivery


def main() -> None:
    platform.enable_compile_cache()
    in_path, out_path, out_rate = sys.argv[1], sys.argv[2], int(sys.argv[3])
    frames, in_rate = read_wav(in_path)
    lpf = int(sys.argv[4]) if len(sys.argv) > 4 else out_rate
    channels = frames.shape[1]
    print(f"{in_path}: {frames.shape[0]} frames @ {in_rate} Hz -> {out_rate} Hz (lpf {lpf})")

    rs = HighLevelResampler.init(channels, in_rate, out_rate, lpf)
    if rs is None:
        sys.exit("unsupported configuration")

    cursor = 0

    def input_callback(total_frames: int) -> np.ndarray:
        nonlocal cursor
        give = min(total_frames, CHUNK, frames.shape[0] - cursor)
        out = frames[cursor : cursor + give]
        cursor += give
        return out

    wide = rs.resample_stream(input_callback)  # resample + ResampleEnd flush
    write_wav(out_path, clamp_s16(wide), out_rate)
    print(f"{out_path}: {wide.shape[0]} frames written")


if __name__ == "__main__":
    main()
