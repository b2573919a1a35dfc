#!/usr/bin/env python3
"""Whole-buffer resampling via the low-level API.

Mirrors the reference's examples/low-level.c (embedded clownresampler.h:38-249):
load a file, pad it with radius zero-frames at both ends, resample in one shot,
clamp to 16-bit and write out. Here the decode/playback scaffolding (dr_mp3 /
miniaudio in the reference) is replaced with WAV/raw-PCM helpers.

Usage: python examples/low_level.py in.wav out.wav <out_rate> [lpf_rate]
"""

import sys

sys.path.insert(0, ".")

from clownresampler_tpu import platform, resample_array
from clownresampler_tpu.utils.audio_io import clamp_s16, read_wav, write_wav


def main() -> None:
    platform.enable_compile_cache()
    in_path, out_path, out_rate = sys.argv[1], sys.argv[2], int(sys.argv[3])
    frames, in_rate = read_wav(in_path)
    lpf = int(sys.argv[4]) if len(sys.argv) > 4 else out_rate
    print(f"{in_path}: {frames.shape[0]} frames @ {in_rate} Hz -> {out_rate} Hz (lpf {lpf})")

    # resample_array pads with the kernel radius internally
    # (the low-level contract of clownresampler.h:725-733).
    wide = resample_array(frames, in_rate, out_rate, lpf)

    # The library outputs unclamped wide samples (clownresampler.h:811-820);
    # clamping to s16 is the application's job, as in the reference examples.
    write_wav(out_path, clamp_s16(wide), out_rate)
    print(f"{out_path}: {wide.shape[0]} frames written")


if __name__ == "__main__":
    main()
