"""Mesh sharding: DP x SP results must equal the unsharded batch bit-for-bit.

Runs on the 8-virtual-device CPU mesh (conftest.py); chip_smoke.py
--four-cards runs the sharded paths on four GPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu.batch import make_batch_state, resample_batch
from clownresampler_tpu.configure import configure
from clownresampler_tpu.models import lanczos_kernel_table
from clownresampler_tpu.parallel import make_mesh, sharded_resample_batch


def _setup(b, n_in, channels, seed=5):
    rng = np.random.default_rng(seed)
    ratios = [(48000, 44100), (8000, 44100), (96000, 48000), (44100, 48000)]
    configs = []
    for i in range(b):
        in_rate, out_rate = ratios[i % len(ratios)]
        cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
        configs.append((cfg, fx.calculate_ratio(in_rate, out_rate)))
    max_radius = max(c.integer_stretched_kernel_radius for c, _ in configs)
    buf = np.zeros((b, n_in + 2 * max_radius, channels), np.int16)
    for i, (cfg, _) in enumerate(configs):
        r = cfg.integer_stretched_kernel_radius
        buf[i, r : r + n_in] = rng.integers(-32768, 32768, size=(n_in, channels))
    return configs, buf, max_radius


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_equals_unsharded(dp, sp):
    assert len(jax.devices()) >= dp * sp
    b, n_in, channels, n_out = 8, 192, 2, 512
    configs, buf, max_radius = _setup(b, n_in, channels)
    table = jnp.asarray(lanczos_kernel_table())
    states = make_batch_state(configs)
    totals = jnp.full((b,), n_in, jnp.int32)
    quotas = jnp.full((b,), 10**6, jnp.int32)
    max_taps = 2 * max_radius

    ref = resample_batch(
        table, jnp.asarray(buf), totals, states, quotas, max_taps=max_taps, n_out=n_out
    )

    mesh = make_mesh(dp=dp, sp=sp)
    got = sharded_resample_batch(
        mesh,
        table,
        jnp.asarray(buf),
        totals,
        states,
        quotas,
        max_taps=max_taps,
        n_out=n_out,
    )

    for r, g, name in zip(ref, got, ["out", "produced", "consumed", "state", "exhausted"]):
        r_leaves = jax.tree.leaves(r)
        g_leaves = jax.tree.leaves(g)
        for rl, gl in zip(r_leaves, g_leaves):
            np.testing.assert_array_equal(np.asarray(rl), np.asarray(gl), err_msg=name)


def test_quota_split_over_sp():
    """Output quotas must partition correctly across sp shards."""
    b, n_in, channels, n_out = 4, 192, 2, 512
    configs, buf, max_radius = _setup(b, n_in, channels, seed=9)
    table = jnp.asarray(lanczos_kernel_table())
    states = make_batch_state(configs)
    totals = jnp.full((b,), n_in, jnp.int32)
    quotas = jnp.asarray([3, 100, 257, 511], jnp.int32)
    max_taps = 2 * max_radius

    ref = resample_batch(
        table, jnp.asarray(buf), totals, states, quotas, max_taps=max_taps, n_out=n_out
    )
    mesh = make_mesh(dp=2, sp=4)
    got = sharded_resample_batch(
        mesh, table, jnp.asarray(buf), totals, states, quotas,
        max_taps=max_taps, n_out=n_out,
    )
    for rl, gl in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(rl), np.asarray(gl))


def test_sharded_uniform_fast_path():
    """Lane-sharded uniform launch == the single-device lanes route."""
    import jax.numpy as jnp
    from clownresampler_tpu.lowlevel import make_device_state
    from clownresampler_tpu.models import lanczos_kernel_table
    from clownresampler_tpu.ops.resample import resample_lanes
    from clownresampler_tpu.parallel import sharded_uniform_resample

    rng = np.random.default_rng(13)
    cfg = configure(48000, 44100, 44100)
    inc = fx.calculate_ratio(48000, 44100)
    state = make_device_state(0, 0x1234, cfg, inc)
    n_out, lanes = 64, 1024  # 128 lanes on each of 8 dp shards
    s = ((n_out * inc) >> 16) + 96
    s = -(-s // 16) * 16
    x = jnp.asarray(rng.integers(-32768, 32768, size=(s, lanes)).astype(np.int32))
    table = jnp.asarray(lanczos_kernel_table())

    ref = resample_lanes(table, x, state, max_taps=8, n_out=n_out)
    mesh = make_mesh(dp=8, sp=1)
    got = sharded_uniform_resample(mesh, table, x, state, max_taps=8, n_out=n_out)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
