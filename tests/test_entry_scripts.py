"""bench.py and chip_smoke.py refuse to report without a GPU: they exit
non-zero and print no result line."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_fails_without_gpu():
    out = _run(os.path.join(ROOT, "bench.py"), ROOT, "--quick")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_gpu():
    out = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_gpu_lane_fails_without_gpu():
    """The gpu lane run on a machine where JAX finds no GPU fails rather
    than passing with every test skipped."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", HSRK_GPU_LANE="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-p", "no:xdist",
         "tests/test_gpu.py::test_device_encode_matches_host"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "JAX found no GPU" in out.stdout
