import os
import subprocess
import sys
import textwrap

# Tests run on the single real CPU device (the 512-device farm is ONLY for
# launch/dryrun.py).  Multi-device suites go through the `run_forced8`
# fixture below, which isolates the forced device count in a subprocess.
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
sys.path.insert(0, SRC)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def tiny_corpus():
    from repro.data import synthetic

    return synthetic.make_corpus(m=300, d=16, avg_tokens=8, max_tokens=12,
                                 n_centers=24, seed=0)


@pytest.fixture(scope="session")
def run_forced8():
    """Run a python snippet in a subprocess with 8 forced XLA host devices.

    The forced device count lives ONLY in the subprocess environment
    (``XLA_FLAGS``), never in this process — the main test process keeps the
    default single device no matter how pytest orders the suites, and the
    multi-device suites (test_distributed / test_dist_serve) all share this
    one helper instead of each mutating env on their own."""

    def _run(code: str, *, n_devices: int = 8, timeout: int = 560) -> str:
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={n_devices}")
        env["PYTHONPATH"] = SRC
        r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                           capture_output=True, text=True, env=env,
                           timeout=timeout)
        assert r.returncode == 0, (
            f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-4000:]}")
        return r.stdout

    return _run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one "
        "(run on the card: python -m pytest -m gpu tests/test_torch_*.py)")
