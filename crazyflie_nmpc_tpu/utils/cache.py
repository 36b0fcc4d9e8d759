"""Persistent-compilation-cache setup.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX
reads that variable itself; this module then sets no directory), otherwise
one fixed directory inside the checkout, `<repo>/.jax_cache` (listed in
.gitignore).  A fixed path matters: the path is part of what makes a later
run find an entry again.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir(environ=None) -> str:
    """The compile-cache directory: the environment's choice, else the
    fixed in-checkout default."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compilation_cache(min_compile_secs: float = 0.5) -> str | None:
    """Turn on JAX's persistent cache at `cache_dir()`; returns the path.

    On the CPU backend the cache is left DISABLED: this jaxlib's XLA:CPU
    AOT deserialization intermittently segfaults even on same-host entries
    (observed at `compilation_cache.get_executable_and_time`, preceded by
    'Machine type used for XLA:CPU compilation doesn't match' loader
    errors).  GPU executables don't go through that loader.
    """
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


@contextmanager
def persistent_cache_disabled():
    """Skip the persistent compilation cache for compiles in this context.

    jax 0.9 has no per-backend cache scoping: once the cache is enabled
    for the GPU (setup_compilation_cache above), CPU-*pinned* executables
    compiled in the same process — e.g. the host-side simulated plant of
    a serving run — would be persisted and re-loaded through the XLA:CPU
    AOT loader this module documents as intermittently segfaulting.
    Wrapping the CPU jit+warm-up in this context keeps those executables
    process-local while the GPU compiles outside it keep the cache."""
    import jax

    prev = bool(jax.config.jax_enable_compilation_cache)
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
