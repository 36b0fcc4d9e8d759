"""The reference's ACTUAL flight configuration, end-to-end in ONE loop
(VERDICT r3 item 1 — previously closed as two separate halves).

The paper flew (acados_predictor.launch + acados_mpc.cpp + firmware):

    helix Tracking policy (acados_mpc.cpp:458-488)
      -> NMPC u1/x4 -> cmd_vel (acados_mpc.cpp:619-625,644-670)
      -> 60 ms radio round trip (acados_predictor.launch:61-63)
      -> onboard attitude/rate cascade (the firmware inner loop)
    with the NMPC seeing only the estimator chain's reconstruction
    (mocap IIR-LPF velocity fusion + Euler-roundtripped attitude,
    acados_estimator.cpp:356-440) delay-compensated by a single-last-
    command predictor (acados_estimator.cpp:573-593).

runtime.flight_configuration composes every one of those blocks in one
lax.scan.  These tests pin its behavior at the shipped operating point
(delay_steps=4 = 60 ms) under both predictor models:

  * "cmd_vel" — the model-consistent single-last-command predictor
    (propagate through the cascade holding the last attitude command):
    cm-class helix tracking at 60 ms.  THE README headline configuration.
  * "motvel"  — the reference's rotor-level predictor verbatim: measured
    software envelope is delay_steps <= 2 (tools/firmware_envelope.py:
    0/72 gain configs stable at 4); pinned here at both sides of the
    boundary.
"""

import jax.numpy as jnp
import numpy as np

from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu.runtime.closed_loop import (
    LoopConfig,
    flight_configuration,
    tracking_error,
)
from crazyflie_nmpc_tpu.solver import default_ocp
from crazyflie_nmpc_tpu.utils.trajectories import helix_trajectory

CFG = LoopConfig(ipm=IPMConfig(iters=8))


def _setup():
    spec = default_ocp(dtype=jnp.float64)
    table = helix_trajectory(spec.params).astype(jnp.float64)
    return spec, table


def test_paper_flight_helix_tracking_60ms():
    """The composed configuration tracks the helix at cm level with the
    full 60 ms round trip: measured 2.30 cm max / ~1 cm mean over the
    accelerating phase (identical 2.303 cm max over the full 1050-row
    helix; the README headline cites this loop)."""
    spec, table = _setup()
    res = flight_configuration(spec, table, steps=400, delay_steps=4,
                               config=CFG)
    e = tracking_error(res, table)
    assert np.all(np.isfinite(np.asarray(res.x)))
    assert e.max() < 0.03, e.max()
    assert e[100:].mean() < 0.015, e[100:].mean()
    # the onboard mixer's rotor commands stay inside the envelope
    u = np.asarray(res.u)
    assert u.min() >= 0.0 and u.max() <= 22.0


def test_paper_flight_delay_split_indifferent():
    """Placing part of the round trip on the sensing leg (stale mocap,
    dm=2) instead of all-actuation changes nothing material: the
    single-last-command predictor compensates the TOTAL delay
    (acados_estimator's `delay` rosparam is sensing-to-actuation)."""
    spec, table = _setup()
    res = flight_configuration(spec, table, steps=400, delay_steps=4,
                               meas_delay_steps=2, config=CFG)
    e = tracking_error(res, table)
    assert np.all(np.isfinite(np.asarray(res.x)))
    assert e.max() < 0.035, e.max()


def test_motvel_predictor_envelope_in_full_configuration():
    """The reference's literal rotor-level predictor inside the full
    composition: bounded (degraded ~0.22 m) at its measured envelope
    delay_steps=2, divergent at the shipped 60 ms (matches the
    standalone envelope study: the published rotor plan and the mixer's
    actual output diverge during transients, and 60 ms of prediction
    error compounds through the open-loop-unstable attitude dynamics —
    which is exactly why the model-consistent predictor exists)."""
    spec, table = _setup()
    inside = flight_configuration(spec, table, steps=400, delay_steps=2,
                                  predictor="motvel", config=CFG)
    e_in = tracking_error(inside, table)
    assert np.all(np.isfinite(np.asarray(inside.x)))
    assert e_in.max() < 0.5, e_in.max()

    beyond = flight_configuration(
        spec, table, steps=400, delay_steps=4, predictor="motvel",
        config=LoopConfig(ipm=IPMConfig(iters=8), guard_failures=False))
    e_out = tracking_error(beyond, table)
    worst = np.nanmax(np.where(np.isfinite(e_out), e_out, np.inf))
    assert (not np.all(np.isfinite(e_out))) or worst > 1.0, worst
