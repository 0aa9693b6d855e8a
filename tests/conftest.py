"""Test configuration: force the CPU backend with 8 virtual devices so
sharding tests exercise a multi-device mesh without accelerator hardware
(SURVEY §4: the fake-backend layer the reference lacks).

The tier-1 suite runs on the CPU (`JAX_PLATFORMS=cpu python -m pytest
tests/`); the GPU check is `python chip_smoke.py` on a machine with an
NVIDIA GPU (see README).  The persistent compilation cache is switched off
here: the suite compiles many small programs once each, and subprocesses
inherit the setting through the environment."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables after each test module.

    A single serial run of the whole suite accumulates hundreds of XLA:CPU
    compilations in one process; past ~170 tests the next compile segfaults
    inside `backend_compile_and_load` (observed repeatedly at
    test_suite.py::test_write_suite_roundtrip). Releasing executables
    between modules keeps the JIT arena small; the cost is re-compiling
    shared programs at each module boundary (~tens of seconds serially,
    invisible under xdist which isolates modules per worker anyway)."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-process tests"
    )
