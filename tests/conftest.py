"""Test environment: the CPU platform (unless JAX_PLATFORMS says
otherwise) with 8 virtual devices, so multi-device sharding paths run
without accelerators. Tests marked `gpu` need an NVIDIA GPU and skip
elsewhere; run them on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's first device is a GPU
    (decided here, when the test runs — never at import or collection)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform}); run "
                    "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def small_grid(rng):
    """A smooth 24^3 test volume in [0, 1]."""
    n = 24
    z, y, x = np.meshgrid(
        np.linspace(0, 1, n), np.linspace(0, 1, n), np.linspace(0, 1, n),
        indexing="ij")
    g = 0.5 + 0.5 * np.sin(6 * x) * np.cos(5 * y) * np.sin(4 * z + 1.0)
    return g.astype(np.float32)
