"""Property fuzz: random ratios x random chunkings, farm == host == one-shot.

The host LowLevelResampler is proven bit-exact against the C oracle; this
closes the loop by fuzzing the production (farm) path against it across the
whole supported ratio space, including ratios no curated list would pick.
"""

import numpy as np
import pytest

from clownresampler_tpu.configure import configure
from clownresampler_tpu.farm import UniformStreamFarm
from tests.test_farm import _host_reference

RNG = np.random.default_rng(0xC0FFEE)


def _random_ratio(rng, max_radius=40):
    while True:
        in_rate = int(rng.integers(1, 200_000))
        out_rate = int(rng.integers(1, 200_000))
        cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
        # bound staging size and runtime per case
        if cfg is not None and cfg.integer_stretched_kernel_radius <= max_radius:
            return in_rate, out_rate


def _random_wide_ratio(rng):
    """Ratios with wide windows: radius > 512 up to the reference's de facto
    scale <= resolution limit (configure rejects the step==0 domain where
    the reference itself divides by zero)."""
    while True:
        in_rate = int(rng.integers(30_000, 200_000))
        out_rate = int(rng.integers(40, 250))
        cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
        if cfg is not None and cfg.integer_stretched_kernel_radius > 512:
            return in_rate, out_rate


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_farm_matches_host(seed):
    rng = np.random.default_rng(seed * 7919 + 13)
    in_rate, out_rate = _random_ratio(rng)
    ch = int(rng.integers(1, 4))
    total = int(rng.integers(150, 600))
    data = rng.integers(-32768, 32768, size=(2, total, ch)).astype(np.int16)

    farm = UniformStreamFarm(
        2, ch, in_rate, out_rate, max(in_rate, out_rate),
        chunk_frames=256,
    )
    outs = []
    cursor = 0
    while cursor < total:
        size = min(int(rng.integers(1, 256)), total - cursor)
        outs.append(farm.process(data[:, cursor : cursor + size]))
        cursor += size
    outs.append(farm.flush())
    got = np.concatenate(outs, axis=1)

    for i in range(2):
        want = _host_reference(data[i], ch, in_rate, out_rate, max(in_rate, out_rate))
        np.testing.assert_array_equal(
            got[i], want, err_msg=f"ratio {in_rate}->{out_rate} ch={ch} stream {i}"
        )


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_wide_kernel_farm_matches_host(seed):
    """Full ratio domain: random wide-window ratios — the reference accepts
    everything below kernel_scale 0x1000 (clownresampler.h:974-975); the
    farm must serve them bit-exactly, never miscompile or OOM."""
    rng = np.random.default_rng(seed * 104729 + 7)
    in_rate, out_rate = _random_wide_ratio(rng)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    r = cfg.integer_stretched_kernel_radius
    total = 3 * r + int(rng.integers(100, 500))   # a few output frames' worth
    data = rng.integers(-32768, 32768, size=(2, total, 1)).astype(np.int16)

    farm = UniformStreamFarm(
        2, 1, in_rate, out_rate, max(in_rate, out_rate),
        chunk_frames=total,
    )
    got = np.concatenate([farm.process(data), farm.flush()], axis=1)
    for i in range(2):
        want = _host_reference(data[i], 1, in_rate, out_rate, max(in_rate, out_rate))
        np.testing.assert_array_equal(
            got[i], want, err_msg=f"ratio {in_rate}->{out_rate} radius {r} stream {i}"
        )
