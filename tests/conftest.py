"""Test environment: an 8-virtual-device CPU JAX platform by default.

Tests validate numerics and multi-device sharding on the virtual CPU mesh.
Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on a
machine with one by

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

(the CPU backend hosts the oracle those tests compare against).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided here, at
    run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")


# ---------------------------------------------------------------------------
# Fast tier: `pytest -m "not slow"` is the <5 min inner loop; the full suite
# (no -m) runs everything and stays the merge gate. Heavy integration tests
# (farm/scan/sharded end-to-end replays, fuzz sweeps, batched-dispatch
# oracles) are marked centrally here by original test name — every subsystem
# keeps at least one quick bit-exact representative in the fast tier.
# Tier-budget rule: new tests that replay full farms/scans/sharded streams,
# fuzz across many configs, or take >~10 s on the CPU mesh go in this set.
# tests/test_meta.py asserts every entry still names a collected test, so a
# rename cannot silently un-mark a heavy test.
SLOW_TESTS = {
    # farm end-to-end replays vs the host oracle
    "test_mixed_farm_adjust_stream_capacity_drift",
    "test_farm_launch_tiling_matches_host",
    "test_farm_clamp_s16_output",
    "test_mixed_farm_per_stream_adjust",
    "test_farm_matches_host",
    "test_multilane_general_dispatch_bit_exact",
    "test_wide_reserve_narrow_ratio_fast_kernel_dispatch",
    "test_farm_device_staging_matches_host_staging",
    "test_mixed_farm_matches_host",
    "test_farm_pitch_bend_matches_host",
    "test_mixed_farm_clamp_s16",
    # checkpoint/resume integration
    "test_sharded_mixed_farm_checkpoint_resume",
    "test_mixed_farm_checkpoint_resume",
    "test_sharded_farm_checkpoint_resume",
    # batched bulk dispatch oracles
    "test_batched_tile_dispatch_bit_exact",
    # sharded farm integration
    "test_sharded_mixed_farm_matches_mixed_farm",
    "test_sharded_farm_matches_uniform_farm",
    "test_sharded_farm_adjust_pitch_bend",
    # whole-stream scans
    "test_scan_fused_split_chains_bit_exact",
    "test_scan_fused_matches_oracle_scan",
    "test_scan_fused_pipeline_bit_exact",
    # heavy examples / high-level streams
    "test_multichip_farm_example",
    "test_bulk_then_incremental_resume",
    "test_resample_stream_bulk_fused_identical_bytes",
    "test_realtime_refusal_resumes_bit_exact",
    "test_fuzz_farm_matches_host",
    "test_lowest_level_frames_bit_exact",
}


def pytest_collection_modifyitems(config, items):
    import pytest

    slow = pytest.mark.slow
    for item in items:
        name = getattr(item, "originalname", None) or item.name
        if name in SLOW_TESTS:
            item.add_marker(slow)
