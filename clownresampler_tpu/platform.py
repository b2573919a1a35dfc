"""The one place that knows which machine the package runs on.

It answers, for every other module:

* which backend this process runs on: ``"gpu"`` (an NVIDIA card, the
  deployment target) or ``"cpu"`` (the test suite); anything else is refused;
* whether device-resident staging and the bulk stream route are the
  defaults here (``on_accelerator``);
* how much device memory there is (``device_memory_bytes``);
* where compiled programs are cached (``enable_compile_cache``).

Every launch takes the same XLA route on both backends (ops/resample.py):
nothing falls back to the CPU or to an interpreter.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import jax

SUPPORTED_BACKENDS = ("gpu", "cpu")

# Compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a fixed
# directory inside the checkout (git-ignored), so a later process finds it.
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def backend() -> str:
    """The JAX backend of this process, checked against the supported set."""
    name = jax.default_backend()
    if name not in SUPPORTED_BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}; clownresampler_tpu runs on "
            f"{' or '.join(SUPPORTED_BACKENDS)}")
    return name


def on_accelerator() -> bool:
    """True on the GPU: device-resident staging and the bulk stream route
    are the defaults there; the CPU keeps staging in host memory."""
    return backend() == "gpu"


def device_memory_bytes() -> Optional[int]:
    """The first device's usable memory as the runtime reports it, or None
    where it reports none (the CPU backend)."""
    stats = jax.devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compile cache for this process.

    Called by the entry points (bench.py, chip_smoke.py, the examples), not
    on import: the process owner decides. Where a cache directory is already
    configured (JAX reads JAX_COMPILATION_CACHE_DIR itself, or the caller
    set jax_compilation_cache_dir), nothing is set here; otherwise the cache
    goes to CACHE_DIR."""
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
