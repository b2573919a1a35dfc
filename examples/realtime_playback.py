#!/usr/bin/env python3
"""Realtime-playback-shaped consumer: a simulated audio device driving the
high-level API with a REFUSING output callback.

Mirrors the reference's embedded examples (clownresampler.h:83-125 low-level,
301-343 high-level): an audio device thread periodically asks for a fixed-size
buffer of frames; the audio callback resamples directly into it, the output
callback clamps each sample to +-0x7FFF and returns False (the C callback
returns 0) when the device buffer is full — stopping the resampler mid-stream
with its position bookkeeping intact — and any remainder after end-of-stream
is zero-filled (clownresampler.h:124 / 342).

Usage: python examples/realtime_playback.py in.wav out.wav <out_rate> [lpf]
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from clownresampler_tpu import HighLevelResampler, platform
from clownresampler_tpu.utils.audio_io import read_wav, write_wav

DEVICE_BUFFER_FRAMES = 512   # one device period (miniaudio-ish default)
INPUT_CHUNK = 2048           # frames per input-callback delivery


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
        give = min(total_frames, INPUT_CHUNK, frames.shape[0] - cursor)
        out = frames[cursor : cursor + give]
        cursor += give
        return out

    input_exhausted = False

    def audio_callback(device_buffer: np.ndarray) -> int:
        """Fill one device period; returns frames written (clownresampler.h:
        83-125). The output callback refuses once the buffer is full; the
        resampler's next call resumes exactly where the refusal stopped it."""
        nonlocal input_exhausted
        written = 0

        def output_callback(frame: np.ndarray) -> bool:
            nonlocal written
            # Clamp the wide int32 samples to s16 — the caller's job per the
            # output-callback contract (clownresampler.h:96-100, 811-820).
            device_buffer[written] = np.clip(frame, -0x7FFF, 0x7FFF)
            written += 1
            return written < device_buffer.shape[0]

        if not input_exhausted:
            input_exhausted = rs.resample(input_callback, output_callback)
        if input_exhausted and written < device_buffer.shape[0]:
            # Tail flush (ResampleEnd) also honours the refusal contract.
            done = rs.resample_end(output_callback)
            if done and written < device_buffer.shape[0]:
                device_buffer[written:] = 0  # zero-fill: stream is over (124)
                return written
        return device_buffer.shape[0]

    # Simulated device loop: keep requesting periods until a short write.
    periods = []
    while True:
        buf = np.empty((DEVICE_BUFFER_FRAMES, channels), np.int16)
        n = audio_callback(buf)
        periods.append(buf[:n].copy())
        if n < DEVICE_BUFFER_FRAMES:
            break

    out = np.concatenate(periods, axis=0)
    write_wav(out_path, out, out_rate)
    print(f"{out_path}: {out.shape[0]} frames written "
          f"({len(periods)} device periods of {DEVICE_BUFFER_FRAMES})")


if __name__ == "__main__":
    main()
