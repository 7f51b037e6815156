"""Test configuration: force an 8-virtual-device CPU backend so sharding /
multi-device code paths are exercised without a GPU, per the project's
test strategy (SURVEY.md §4). Must run before any test module imports jax.
The platform is set through jax.config as well as JAX_PLATFORMS, so the
suite stays on the CPU on a machine that has a card. The card is reached
through `python chip_smoke.py`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_compiler_state():
    """Clear JAX's compilation caches after every test module. A full-suite
    run compiles hundreds of distinct executables on the 8-virtual-device
    CPU backend; letting that state accumulate ends with a segfault inside
    XLA's backend_compile (observed at ~98% of the suite). Per-module
    clearing bounds it; modules rarely share jit signatures anyway."""
    yield
    import jax as _jax

    _jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end runs (the rendered-circuit "
        "system proof); included by default, deselect with -m 'not slow'")
