"""Cross-cutting coverage: non-default models through the launch route,
the scan pipeline on the golden fixture, max-channel farms."""

import jax.numpy as jnp
import numpy as np

from clownresampler_tpu import fixedpoint as fx
from clownresampler_tpu.configure import configure
from clownresampler_tpu.farm import UniformStreamFarm
from clownresampler_tpu.lowlevel import make_device_state, resample_scan
from clownresampler_tpu.models import HIGH_QUALITY_MODEL
from clownresampler_tpu.ops.convolve import convolve_frames
from clownresampler_tpu.ops.resample import resample_lanes
from tests import oracle


def test_tiled_kernel_high_quality_model():
    """radius-10 model through the lanes route (24 taps, d=1)."""
    model = HIGH_QUALITY_MODEL
    table = jnp.asarray(model.table())
    cfg = configure(48000, 44100, 44100, radius=model.radius, resolution=model.resolution)
    inc = fx.calculate_ratio(48000, 44100)
    state = make_device_state(0, 0x77, cfg, inc)
    max_taps = -(-2 * cfg.integer_stretched_kernel_radius // 8) * 8
    n_out = 64
    rng = np.random.default_rng(3)
    s = ((n_out * inc) >> 16) + 2 * cfg.integer_stretched_kernel_radius + 96
    s = -(-s // 16) * 16
    x = jnp.asarray(rng.integers(-32768, 32768, size=(s, 128)).astype(np.int32))
    got = resample_lanes(table, x, state, max_taps=max_taps, n_out=n_out)
    n = jnp.arange(n_out, dtype=jnp.int32)
    pos, frac = fx.positions_from_state(
        state.position_integer, state.position_fractional,
        state.cfg.increment_hi, state.cfg.increment_lo, n,
    )
    want = convolve_frames(table, x, pos, frac, state.cfg, max_taps)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_scan_reproduces_golden_prefix():
    """The jitted scan pipeline on the real fixture matches the C golden."""
    from clownresampler_tpu.models import lanczos_kernel_table

    pcm = oracle.pcm_fixture()[:8192]          # 8192 frames of the fixture
    golden = oracle.golden("golden_44100_8000.raw").reshape(-1, 2)
    cfg = configure(44100, 8000, 44100)
    inc = fx.calculate_ratio(44100, 8000)
    r = cfg.integer_stretched_kernel_radius
    max_taps = -(-2 * r // 8) * 8
    n_in, k = 1024, 8
    chunks = jnp.asarray(pcm.reshape(k, n_in, 2))
    n_out_cap = ((n_in + 2 * r) * 65536) // inc + 16
    state = make_device_state(0, 0, cfg, inc)
    outputs, produced, _, backlog = resample_scan(
        jnp.asarray(lanczos_kernel_table()), chunks, state,
        max_taps=max_taps, n_out=int(n_out_cap), radius=r,
    )
    assert not bool(backlog)
    outputs, produced = np.asarray(outputs), np.asarray(produced)
    got = np.concatenate([outputs[i, : produced[i]] for i in range(k)], axis=0)
    # The scan holds back a radius tail; everything it emitted must equal the
    # golden prefix (the golden was produced from the full 192000-frame file,
    # whose continuation only affects frames beyond the hold-back).
    np.testing.assert_array_equal(got, golden[: got.shape[0]])
    assert got.shape[0] > 1200  # produced a substantial prefix


def test_farm_sixteen_channels():
    """MAXIMUM_CHANNELS-wide frames through the farm (reference limit 16)."""
    rng = np.random.default_rng(9)
    b, ch, total = 2, 16, 300
    data = rng.integers(-32768, 32768, size=(b, total, ch)).astype(np.int16)
    farm = UniformStreamFarm(b, ch, 32000, 48000, 48000, chunk_frames=128)
    outs = []
    for off in range(0, total, 128):
        outs.append(farm.process(data[:, off : off + 128]))
    outs.append(farm.flush())
    got = np.concatenate(outs, axis=1)

    from tests.test_farm import _host_reference

    for i in range(b):
        want = _host_reference(data[i], ch, 32000, 48000, 48000)
        np.testing.assert_array_equal(got[i], want, err_msg=f"stream {i}")
