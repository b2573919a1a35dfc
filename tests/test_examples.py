"""Example scripts and the CLI must run end-to-end (subprocess, CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    from clownresampler_tpu.utils.audio_io import write_wav

    rng = np.random.default_rng(2)
    path = tmp_path_factory.mktemp("wav") / "in.wav"
    write_wav(str(path), rng.integers(-15000, 15000, size=(12000, 2)).astype(np.int16), 48000)
    return str(path)


def _run(args, wav_path, out_name):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    out = os.path.join(os.path.dirname(wav_path), out_name)
    r = subprocess.run(
        [sys.executable, *args, wav_path, out, "32000"],
        cwd=REPO, capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert os.path.exists(out)
    return r.stdout


def test_low_level_example(wav_path):
    out = _run(["examples/low_level.py"], wav_path, "out_ll.wav")
    assert "8000 frames written" in out  # 12000 * 32000/48000


def test_high_level_example(wav_path):
    out = _run(["examples/high_level.py"], wav_path, "out_hl.wav")
    assert "8000 frames written" in out


def test_realtime_playback_example(wav_path):
    out = _run(["examples/realtime_playback.py"], wav_path, "out_rt.wav")
    # 12000 * 32000/48000 = 8000 resampled frames + the radius tail the
    # ResampleEnd flush emits, delivered in 512-frame device periods.
    assert "device periods of 512" in out
    import re

    m = re.search(r"(\d+) frames written", out)
    assert m and int(m.group(1)) >= 8000


def test_cli_module(wav_path):
    out = _run(["-m", "clownresampler_tpu"], wav_path, "out_cli.wav")
    assert "8000 frames" in out


def test_cli_usage_error():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "clownresampler_tpu"],
        cwd=REPO, capture_output=True, text=True, env=env,
    )
    assert r.returncode == 2
    assert "in.wav out.wav" in r.stderr


def test_multichip_farm_example():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "examples/multichip_farm.py", "128"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "sharded farm: 128 streams" in r.stdout
    assert "per-stream adjust" in r.stdout


def test_bench_refuses_cpu():
    """bench.py measures the GPU only: on the CPU it exits non-zero and
    prints no result line."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "bench.py"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 2, r.stderr[-800:]
    assert "GPU only" in r.stderr
    assert r.stdout.strip() == ""


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result line without a GPU."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
