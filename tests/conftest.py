"""Test harness: force an 8-device virtual CPU mesh.

The tests run on the CPU; sharding tests run on XLA's host-platform virtual
devices (SURVEY.md section 4's multi-host test strategy). The backend is
pinned through jax.config before any backend initializes, and the persistent
compile cache is off so that entry points called by tests write nothing into
the checkout.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
