"""Test configuration: run on CPU with a virtual 8-device mesh and f64.

Multi-chip sharding is validated without accelerator hardware by forcing
the host platform to expose 8 virtual devices (the standard XLA trick);
numerics tests use float64 so golden comparisons are not precision-limited.
XLA_FLAGS must be set before the first backend initialization.

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; a fixture (never
the import of a module) decides.  On a GPU host run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (utils/cache.py: left off on the CPU backend,
# whose AOT loader is unreliable on this jaxlib).
from crazyflie_nmpc_tpu.utils.cache import setup_compilation_cache  # noqa: E402

setup_compilation_cache()

import pytest  # noqa: E402


def _gpus():
    return [d for d in jax.devices() if d.platform == "gpu"]


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a `gpu`-marked test where JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") is not None and not _gpus():
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")


@pytest.fixture
def gpu_devices():
    """The GPU devices of this host (a `gpu`-marked test's mesh)."""
    return _gpus()


@pytest.fixture(autouse=True, scope="module")
def _bounded_compile_footprint():
    """Drop JAX's in-memory executable/tracing caches after every module.

    The suite compiles hundreds of distinct XLA:CPU programs (several at
    f64, N up to 400); with all executables held live in one process the
    cumulative footprint eventually segfaults the XLA:CPU compiler on
    this jaxlib (observed in rounds 1-2 at ~163/177 tests — the crash
    site moves with test order, the cause is suite-global).  Clearing
    per module bounds the live-executable set to one module's worth;
    the persistent on-disk compilation cache (setup_compilation_cache
    above) makes any re-compile of a shared computation a cheap reload.
    """
    yield
    jax.clear_caches()
