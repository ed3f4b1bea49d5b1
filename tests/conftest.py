"""Shared fixtures.  NOTE: no XLA_FLAGS here -- smoke tests and benches must
see the real single-CPU device; the multi-device cases (``multi_device_host``
below, launch/dryrun.py) force their device counts in SEPARATE processes."""

import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

try:  # real hypothesis when available; deterministic fallback otherwise
    import hypothesis  # noqa: F401

    _USING_SHIM = False
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_fallback",
        os.path.join(os.path.dirname(__file__), "_hypothesis_fallback.py"),
    )
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    _mod.install()
    _USING_SHIM = True


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's kernels); skips without one",
    )


def pytest_addoption(parser):
    # CI pins the differential harness with --hypothesis-seed; real
    # hypothesis registers that flag itself, so only the shim (which is
    # deterministic regardless -- the value is accepted and ignored) needs
    # to add it to keep the same command line working everywhere.
    if _USING_SHIM:
        parser.addoption(
            "--hypothesis-seed",
            action="store",
            default=None,
            help="accepted for CI parity; the deterministic fallback shim "
            "derives per-test seeds from test names instead",
        )

from repro.core import tree as tree_lib
from repro.data.keysets import make_tree_data

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_forced_multi_device(body: str, devices: int = 8, timeout: int = 1800) -> str:
    """Run a test snippet on a forced ``devices``-CPU host.

    The XLA device-count flag must be set BEFORE jax initializes, and this
    process must keep its single real device, so the snippet executes in a
    subprocess with the repo's src on the path and the common imports
    (numpy/jax/make_mesh) pre-bound -- the shared implementation behind
    tests/test_distributed.py and the sharded differential suite.
    """
    code = textwrap.dedent(
        f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
        import sys
        sys.path.insert(0, {os.path.join(_ROOT, 'src')!r})
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.sharding.compat import make_mesh
        """
    ) + textwrap.dedent(body)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout
    )
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def multi_device_host():
    """Fixture handle on ``run_forced_multi_device`` (8 fake devices default)."""
    return run_forced_multi_device


@pytest.fixture(scope="session")
def small_tree():
    keys, values = make_tree_data(1000, seed=7)
    return tree_lib.build_tree(keys, values), keys, values


@pytest.fixture(scope="session")
def medium_tree():
    keys, values = make_tree_data((1 << 12) - 1, seed=11)
    return tree_lib.build_tree(keys, values), keys, values
