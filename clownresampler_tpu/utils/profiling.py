"""Profiling and timing hooks (SURVEY.md section 5: the reference has none).

Usage:
    with trace("resample-trace"):             # open in xprof/tensorboard
        farm.process(chunk)

    seconds = median_seconds(lambda: farm.process(chunk))
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (device + host timelines)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def median_seconds(fn: Callable, warmup: int = 2, reps: int = 7) -> float:
    """Median host-clock seconds of ``fn()``, after ``warmup`` untimed calls.

    The clock stops only once every array ``fn`` returns is ready
    (``jax.block_until_ready``): JAX returns before the device finishes, so
    a timing without it would measure the enqueue. Every output is waited
    for, so no launch can be skipped as dead code.
    """
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
