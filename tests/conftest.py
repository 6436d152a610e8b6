"""Test harness: an 8-device virtual CPU platform unless told otherwise.

Multi-chip sharding is tested on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``), per SURVEY.md §4's strategy
for testing distribution without a pod. The platform is pinned to the CPU
unless ``JAX_PLATFORMS`` says otherwise; the tests marked ``gpu`` run on a
card with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# allow float64 decoder configs in tests for tight oracle comparison
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run on the card with "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu")
    return devs[0]
