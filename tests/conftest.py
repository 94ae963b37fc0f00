"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The sharding tests need several devices, so the CPU backend is split into
eight (SURVEY.md §4). The persistent compile cache is off: CPU compiles are
cheap, and test workers must not share cache files.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided per test, at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; python chip_smoke.py runs these on the card")
