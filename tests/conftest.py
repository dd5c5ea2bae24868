"""Test configuration: force CPU with 8 virtual devices.

The reference has no tests at all (SURVEY §4); the strategy here follows the
JAX idiom of running the full SPMD code on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) so sharding logic is testable
without several GPUs.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them when no GPU is visible.  Run them on a machine with
a card with ``CHAD_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = os.environ.get("CHAD_TEST_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX sees none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (see tests/conftest.py)")
