"""Device-mesh construction helpers for batch/stage sharding."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

BATCH_AXIS = "batch"   # independent OCP instances (drones / scenarios)
STAGE_AXIS = "stage"   # horizon blocks (partial-condensing parallelism)


def make_mesh(batch: int = 1, stage: int = 1, devices=None) -> Mesh:
    """Build a (batch, stage) mesh over `batch*stage` devices.

    batch is the embarrassingly-parallel axis (vmapped solves, BASELINE
    configs 3-5); stage shards the horizon's linearization + condensing
    (SURVEY.md section 2.6).  The cards of one host reach each other all to
    all at the same rate, so the mesh follows the algorithm alone.
    """
    devices = devices if devices is not None else jax.devices()
    n = batch * stage
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(batch, stage)
    return Mesh(arr, (BATCH_AXIS, STAGE_AXIS))
