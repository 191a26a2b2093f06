"""Test harness configuration.

All tests run on CPU with 8 virtual XLA devices (SURVEY.md section 4.3), so
sharding/halo-exchange tests work single-process without a GPU.  Must set
flags before jax initializes.

Tests marked ``gpu`` need the card: a fixture skips them here.  On a GPU
machine, ``ASW_TESTS_ON_CARD=1 python -m pytest tests -m gpu`` runs them on
the card (the variable keeps this file from forcing the CPU).
"""

import os

ON_CARD = os.environ.get("ASW_TESTS_ON_CARD") == "1"

if not ON_CARD:
    # Env vars for any subprocesses; jax may already be imported by a
    # pytest plugin, so also set the config directly below (valid until
    # backend init).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import pytest

from aswstereomatch_tpu.utils import synthetic


@pytest.fixture(scope="session")
def small_pair():
    """Small synthetic pair for loop-oracle comparisons (cheap)."""
    return synthetic.make_pair(height=40, width=56, max_disparity=12, seed=3)


@pytest.fixture(scope="session")
def medium_pair():
    """Medium pair for vectorized-path and sharding tests."""
    return synthetic.make_pair(height=96, width=128, max_disparity=24, seed=7)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX sees none.  Decided here,
    at run time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
