import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_py(code: str, *, devices: int = 1, timeout: int = 420) -> str:
    """Run a python snippet in a fresh process (own XLA device count)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    if devices > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_py


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where there is none)")
