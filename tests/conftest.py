"""Test configuration: an 8-virtual-device CPU mesh with float64.

Tests validate exact semantics (energy invariants, stationarity) on CPU with
x64 enabled, mirroring the reference's Float64 tolerances
(/root/reference/test/runtests.jl:13). GPU runs use float32; the model code
is dtype-agnostic via core/dtypes.py.

The CPU is pinned only when JAX_PLATFORMS is unset, so the `gpu`-marked tests
can run on a card with JAX_PLATFORMS=cuda (see README).
"""

import os

import pytest

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from rrrmc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# the suite is compile-dominated: cached executables make re-runs fast
enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, never
    at import or collection)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")
    return jax.devices()[0]
