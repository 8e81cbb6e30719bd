"""Test configuration: run the suite on a faked 8-device CPU mesh so every
sharding / collective path is exercised without accelerators (SURVEY.md §4,
'Distributed tests without a cluster').

Tests marked ``gpu`` need a GPU; the ``gpu_device`` fixture skips them
when JAX has none.  To run them on a GPU host, let JAX see the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import os
import subprocess

# Must be set before jax is imported anywhere.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# The suite runs on the faked CPU mesh unless JAX_PLATFORMS names the
# platforms explicitly (the ``gpu``-marked tests on a GPU host).
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")


def pytest_configure(config):
    """Build the native decode layer if absent, so its tests never silently
    skip (the reference's decode is load-bearing: main.cpp:14-15)."""
    so = os.path.join(_NATIVE_DIR, "libpmt_native.so")
    if not os.path.exists(so):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=False,
                       capture_output=True, timeout=300)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided when the
    test runs, never at collection)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (JAX found none)")
    return gpus[0]
