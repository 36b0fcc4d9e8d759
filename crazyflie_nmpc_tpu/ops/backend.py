"""Which implementation runs the Riccati sweeps of the batched solver.

One place decides, from the platform JAX runs on:

  "kernel"  the hand-written sweep kernel (`ops.pallas.sweep_kernel`,
            Pallas through Triton), compiled for the GPU;
  "plain"   the same recursion as `lax.scan` in plain JAX (`ops.sweeps`),
            which XLA compiles for any backend.

A third value, "interpret", runs the kernel in the Pallas interpreter.  It
is never chosen here: only a caller (a CPU test) that asks for it gets it.
"""

from __future__ import annotations

import functools

import jax

SWEEPS = ("kernel", "plain", "interpret")


def sweep_backend(platform: str | None = None) -> str:
    """"kernel" on a GPU, "plain" anywhere else.

    platform: a JAX platform name ("gpu", "cpu", ...); None reads the
    default device's platform.
    """
    if platform is None:
        platform = jax.devices()[0].platform
    return "kernel" if platform == "gpu" else "plain"


def resolve_sweep(sweep: str | None) -> str:
    """An explicit choice, validated; None defers to `sweep_backend`."""
    if sweep is None:
        return sweep_backend()
    if sweep not in SWEEPS:
        raise ValueError(f"sweep must be one of {SWEEPS}, got {sweep!r}")
    return sweep


def highest_precision(fn):
    """Trace `fn` with float32 matrix products at full precision.

    On a GPU an f32 product may otherwise run in TF32 (~3 decimal digits),
    which the long sequential Riccati recursions of the plain solver do
    not tolerate.  The setting is read when the products are traced, so
    decorating the traced function pins every product inside it.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
