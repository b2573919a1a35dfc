"""Loader for the C-reference oracle vectors (tests/fixtures/oracle_vectors.npz).

The archive is produced by tools/gen_oracle_vectors.c + tools/pack_vectors.py
from the read-only reference checkout; see those files for the record layouts.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@lru_cache(maxsize=1)
def load():
    data = np.load(os.path.join(FIXTURES, "oracle_vectors.npz"))
    manifest = json.loads(bytes(data["__manifest__"]).decode())
    return data, manifest


def kernel_table() -> np.ndarray:
    data, _ = load()
    return data["kernel_table"]


def configs() -> np.ndarray:
    """Rows: in, out, lpf, ok, stretched, int_radius, delta, step,
    ratio(in,out), ratio(out,in)."""
    data, _ = load()
    return data["configs"]


def lowest_cases():
    """Yield dicts for each single-frame lowest-level case."""
    data, _ = load()
    meta = data["lowest__meta"]
    inputs = data["lowest__input"]
    outputs = data["lowest__output"]
    in_off = 0
    out_off = 0
    for row in meta:
        in_rate, out_rate, lpf, ch, total, pos, frac = (int(v) for v in row)
        n_in = total * ch
        yield {
            "rates": (in_rate, out_rate, lpf),
            "channels": ch,
            "input": inputs[in_off : in_off + n_in].reshape(total, ch),
            "position": (pos, frac),
            "expected": outputs[out_off : out_off + ch],
        }
        in_off += n_in
        out_off += ch


def scripts(kind: str):
    """Yield (name, meta, ops, out, stream) for lowlevel/highlevel scripts."""
    data, manifest = load()
    for name, meta in manifest.items():
        if isinstance(meta, dict) and meta.get("kind") == kind:
            yield (
                name,
                meta,
                data[f"{name}__ops"],
                data[f"{name}__out"],
                data[f"{name}__stream"],
            )


def golden(name: str) -> np.ndarray:
    """Raw s32le golden dump regenerated from the reference (BASELINE.md)."""
    return np.fromfile(os.path.join(FIXTURES, name), dtype="<i4")


def pcm_fixture() -> np.ndarray:
    """tests/test.flac decoded to interleaved s16 stereo (md5 in BASELINE.md)."""
    raw = np.fromfile(os.path.join(FIXTURES, "test_pcm_s16le.raw"), dtype="<i2")
    return raw.reshape(-1, 2)


def convolve_padded(padded, total_frames, in_rate, out_rate, lpf, model=None,
                    p0=0, f0=0):
    """Every frame the reference's LowLevel_Resample emits over ``padded``
    ((total_frames + 2*radius, C) input, clownresampler.h:725-733) from
    phase (p0, f0) until the input is exhausted — computed by
    ops.convolve.convolve_frames with exact host positions, independent of
    the launch route under test."""
    import jax.numpy as jnp

    from clownresampler_tpu import fixedpoint as fx
    from clownresampler_tpu.configure import configure
    from clownresampler_tpu.models import DEFAULT_MODEL
    from clownresampler_tpu.ops.convolve import ConfigScalars, convolve_frames

    model = model or DEFAULT_MODEL
    cfg = configure(in_rate, out_rate, lpf, radius=model.radius,
                    resolution=model.resolution)
    inc = fx.calculate_ratio(in_rate, out_rate)
    num = ((total_frames - p0) << 16) - f0
    n = 0 if num <= 0 else -(-num // inc)
    taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    m = np.arange(n, dtype=np.int64)
    t = f0 + m * inc
    out = convolve_frames(
        jnp.asarray(model.table()), jnp.asarray(np.asarray(padded, np.int16)),
        jnp.asarray((p0 + (t >> 16)).astype(np.int32)),
        jnp.asarray((t & 0xFFFF).astype(np.int32)),
        ConfigScalars.from_configuration(cfg, inc), taps)
    return np.asarray(out)


def convolve_stream(data, in_rate, out_rate, lpf, model=None):
    """The reference's output for a whole (N, C) stream with automatic edge
    padding: ``convolve_padded`` over [radius zeros | data | radius zeros]."""
    from clownresampler_tpu.configure import configure
    from clownresampler_tpu.models import DEFAULT_MODEL

    model = model or DEFAULT_MODEL
    r = configure(in_rate, out_rate, lpf, radius=model.radius,
                  resolution=model.resolution).integer_stretched_kernel_radius
    zeros = np.zeros((r, data.shape[1]), np.int16)
    padded = np.concatenate([zeros, np.asarray(data, np.int16), zeros])
    return convolve_padded(padded, data.shape[0], in_rate, out_rate, lpf, model)
