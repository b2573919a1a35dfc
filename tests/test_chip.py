"""The GPU tier: chip_smoke.py's checks as tests.

Marked ``gpu``: they skip without an NVIDIA GPU. Run them on a machine with
one by ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (the CPU
backend hosts the oracle).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def smoke():
    import jax

    import chip_smoke
    from clownresampler_tpu.models import lanczos_kernel_table

    chip_smoke.CPU = jax.devices("cpu")[0]
    chip_smoke.TABLE = np.asarray(lanczos_kernel_table())
    return chip_smoke


def test_reciprocal_exhaustive_on_gpu(smoke):
    smoke.phase_reciprocal()


def test_goldens_on_gpu(smoke):
    smoke.phase_goldens()


def test_headline_farm_on_gpu(smoke):
    smoke.phase_headline(np.random.default_rng(1))


def test_every_ratio_class_and_path_on_gpu(smoke):
    smoke.phase_classes(np.random.default_rng(2))
