"""Debug-mode invariant checking — the device analogue of CLOWNRESAMPLER_ASSERT.

The reference guards its hot loop with assertions (clownresampler.h:865-868):
kernel-domain bounds (903), the radius-delta invariant (980), window bounds
(1003-1004), and the critical LUT-index range check (1012). Inside jitted device
code there is no assert; this module provides a checked re-run of a launch's
index math that validates the same invariants on the host, for tests and for
debugging data-dependent issues in production pipelines.

Usage:
    report = check_launch(cfg, increment, p0, f0, n_out, input_rows, table_size)
    report.raise_if_violated()
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from clownresampler_tpu.configure import Configuration


@dataclass
class LaunchReport:
    violations: list = field(default_factory=list)
    n_frames: int = 0

    def ok(self) -> bool:
        return not self.violations

    def raise_if_violated(self) -> None:
        if self.violations:
            raise AssertionError(
                f"{len(self.violations)} invariant violations; first: {self.violations[0]}"
            )


def check_launch(
    cfg: Configuration,
    increment: int,
    position_integer: int,
    position_fractional: int,
    n_out: int,
    input_rows: int,
    table_size: int | None = None,
) -> LaunchReport:
    """Validate every frame of a prospective launch against the reference's
    assertion set, using exact host integer arithmetic."""
    table_size = table_size or cfg.radius * 2 * cfg.resolution
    report = LaunchReport(n_frames=n_out)

    n = np.arange(n_out, dtype=np.int64)
    t = position_fractional + n * increment
    pos = position_integer + (t >> 16)
    frac = t & 0xFFFF

    delta = cfg.stretched_kernel_radius_delta
    stretched = cfg.stretched_kernel_radius
    radius = cfg.integer_stretched_kernel_radius
    step = cfg.kernel_step_size

    # clownresampler.h:980 — delta strictly below one.
    if not (0 <= delta < 1 << 16):
        report.violations.append(f"radius delta {delta} outside [0, 65536)")

    min_rel = (frac + delta + 0xFFFF) >> 16
    max_rel = (frac + stretched) >> 16
    kernel_start = (step * ((min_rel << 16) - frac)) >> 16
    taps = radius + max_rel - min_rel

    # clownresampler.h:1003-1004 — window bounds within the radius.
    bad = np.nonzero(min_rel > radius)[0]
    if bad.size:
        report.violations.append(f"min_relative > radius at frame {bad[0]}")
    bad = np.nonzero(max_rel > radius)[0]
    if bad.size:
        report.violations.append(f"max_relative > radius at frame {bad[0]}")

    # clownresampler.h:1012 — every LUT index in range.
    last_kidx = kernel_start + np.maximum(taps - 1, 0) * step
    bad = np.nonzero((last_kidx >= table_size) & (taps > 0))[0]
    if bad.size:
        report.violations.append(
            f"kernel index {int(last_kidx[bad[0]])} >= table size {table_size}"
            f" at frame {int(bad[0])}"
        )

    # Input-window bound: the buffer must cover every tap row (the caller-side
    # padding contract, clownresampler.h:725-733).
    last_row = pos + min_rel + np.maximum(taps - 1, 0)
    bad = np.nonzero(last_row >= input_rows)[0]
    if bad.size:
        report.violations.append(
            f"input row {int(last_row[bad[0]])} >= buffer rows {input_rows}"
            f" at frame {int(bad[0])}"
        )
    bad = np.nonzero(pos + min_rel < 0)[0]
    if bad.size:
        report.violations.append(f"negative window row at frame {int(bad[0])}")

    return report
