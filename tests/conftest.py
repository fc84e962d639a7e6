"""Test config: by default run on an 8-device virtual CPU mesh, so the
sharding tests work anywhere and the golden trajectories replay under the
environment that generated them.

An explicit ``JAX_PLATFORMS`` is honoured: ``JAX_PLATFORMS=cuda pytest -m
gpu`` runs the card-only tests (tests/test_gpu.py) on a GPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# persistent compile cache: the parity suite compiles the full pipeline for
# several distinct configs; cached executables make repeat runs cheap. The
# CPU cache is host-keyed (utils/cachedir.py).
from slam_robot_tpu.utils import cachedir  # noqa: E402

cachedir.configure(os.environ["JAX_PLATFORMS"].split(",")[0], 5.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform}); "
                    "run with JAX_PLATFORMS=cuda pytest -m gpu")
    return dev
