"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests must be deterministic and runnable anywhere, so they run on the CPU
backend (``JAX_PLATFORMS=cpu``) with 8 virtual devices to exercise the
multi-device sharding paths.  The device path is exercised on the CPU by
the counting entry points' ``force_device`` flag.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from w2rap_contigger_tpu.backend import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
