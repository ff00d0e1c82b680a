"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so the multi-device
sharding paths are exercised without accelerators (SURVEY.md §4: "multi-chip
tests runnable on a CPU mesh"); Pallas kernels run in the interpreter, on
explicit request. Checks that need the card carry the `gpu` marker and skip
here; they run as phases of `python chip_smoke.py` on the GPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache (core/cache.py: JAX_COMPILATION_CACHE_DIR when
# set, else .jax_cache/ in the checkout): the suite is compile-bound, and
# recompiling identical programs every run buys nothing.
from rays1bench.core import cache  # noqa: E402

cache.enable()

import pathlib  # noqa: E402

import pytest  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLDEN_DIR


@pytest.fixture
def gpu():
    """Skips unless JAX's default device is a GPU (decided here, at run
    time, never while test modules are imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs as a phase of chip_smoke.py")
