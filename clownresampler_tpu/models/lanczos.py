"""Lanczos windowed-sinc kernel table generation.

Reproduces ClownResampler_Precompute / ClownResampler_LanczosKernel
(clownresampler.h:892-908, 955-961) bit-exactly: the table is computed in IEEE
double precision on the host with the platform libm ``sin`` (via math.sin, the
same glibc routine the C reference calls) and truncated toward zero into int32
16.16 values. The reference documents that the table is a deterministic
constant that may be dumped and embedded (clownresampler.h:677-681), which is
exactly how we treat it: generated once per model on the host, shipped to the
device as a constant, shared by every resampler instance.

numpy's vectorised sin is deliberately NOT used — its SIMD polynomial can
differ from libm by an ulp, which after truncation would flip table entries.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

# The reference hardcodes pi to 100 digits (clownresampler.h:896); parsed to a
# double this is identical to math.pi, but keep the literal for auditability.
_PI_100 = float(
    "3.1415926535897932384626433832795028841971693993751058209749445923078164"
    "062862089986280348253421170679"
)
assert _PI_100 == math.pi


@dataclass(frozen=True)
class KernelModel:
    """A filter model: one (radius, resolution) windowed-sinc design.

    radius: lobes of the sinc window (CLOWNRESAMPLER_KERNEL_RADIUS, default 3).
    resolution: table samples per lobe (CLOWNRESAMPLER_KERNEL_RESOLUTION,
    default 1024).
    """

    radius: int = 3
    resolution: int = 0x400

    @property
    def table_size(self) -> int:
        # clownresampler.h:629 — KERNEL_RADIUS * 2 * KERNEL_RESOLUTION entries.
        return self.radius * 2 * self.resolution

    def table(self) -> np.ndarray:
        return lanczos_kernel_table(self.radius, self.resolution)


def _lanczos(x: float, radius: float) -> float:
    """L(x) = sinc(x) * sinc(x/R) evaluated exactly like the C routine
    (clownresampler.h:892-908): same operation order, same libm sin."""
    x_times_pi = x * _PI_100
    x_times_pi_divided_by_radius = x_times_pi / radius
    if x == 0.0:
        return 1.0
    return (math.sin(x_times_pi) * math.sin(x_times_pi_divided_by_radius)) / (
        x_times_pi * x_times_pi_divided_by_radius
    )


@functools.lru_cache(maxsize=None)
def lanczos_kernel_table(radius: int = 3, resolution: int = 0x400) -> np.ndarray:
    """int32 16.16 kernel LUT, bit-identical to ClownResampler_Precompute.

    Entry i covers x in [-radius, +radius):
        table[i] = (int32) trunc( L((i/size * 2 - 1) * radius) * 65536 )
    with every float op in IEEE double and C's double->long truncation
    (clownresampler.h:960). For the default model the empirically verified
    anchors are table[size/2] == 65536, min == -9651, table[0] == table[-1] == 0
    (SURVEY.md section 2 row 5); the full table is asserted equal to the C dump
    in tests/test_kernel_table.py.
    """
    size = radius * 2 * resolution
    out = np.empty(size, dtype=np.int64)
    fradius = float(radius)
    for i in range(size):
        x = (i / float(size) * 2.0 - 1.0) * fradius
        out[i] = math.trunc(_lanczos(x, fradius) * 65536.0)
    table = out.astype(np.int32)
    table.setflags(write=False)
    return table


# Quality presets (the reference's compile-time trade-off, made runtime).
DEFAULT_MODEL = KernelModel(radius=3, resolution=0x400)
HIGH_QUALITY_MODEL = KernelModel(radius=10, resolution=0x400)
LOW_COST_MODEL = KernelModel(radius=2, resolution=0x200)
