"""Test configuration: an 8-device virtual CPU platform.

Tests run on the CPU with 8 virtual devices so mesh/sharding code paths are
exercised without GPUs (the reference's analog is re-targeting the same
pipeline to the CPU JIT via HL_JIT_TARGET, ``scripts/profile_all.sh``).
The persistent compile cache stays off here: these runs compile for the
CPU, and the cache is for the card.

Tests that need the card carry the ``gpu`` marker; the ``gpu`` fixture
skips them when JAX finds no GPU. On the card they run in one process
(never under xdist: each JAX process reserves most of the card's memory):

    python -m pytest tests -m gpu -q
"""

import os

import pytest

if not os.environ.get("RECFILTER_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_enable_compilation_cache", False)
if not os.environ.get("RECFILTER_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, not import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("no GPU backend: run on the card with "
                    "RECFILTER_TEST_GPU=1 python -m pytest tests -m gpu")
