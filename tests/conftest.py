"""Test configuration: force a virtual 8-device CPU platform.

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise: Pallas
kernels run in interpret mode and the multi-device sharding tests use an
8-device host-platform mesh.  Tests marked ``gpu`` run on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``; chip_smoke.py and
bench.py drive the full-size GPU path.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0x0621)
