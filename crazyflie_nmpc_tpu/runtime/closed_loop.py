"""Closed-loop NMPC simulation: plant + policy + RTI controller in one scan.

The pure-software equivalent of the reference's hardware loop (SURVEY.md
section 4): the plant is the same ERK4 model the estimator's sim solver uses
(estimator and plant share the ODE, so the closed loop is well-defined), the
controller is `solver.rti.rti_step` at the 66.6 Hz tick, and delay
compensation mirrors the reference's pipeline — the state fed to the NMPC is
propagated `delay_steps` stages ahead under the last command
(acados_estimator.cpp:573-593), and the applied command is the stage-1
control u1 (acados_mpc.cpp:619-670 with FIXED_U0=0 publishing u0; the
delay-compensating configuration applies u1).

Everything is one `lax.scan`, so a 20 s flight jit-compiles once and a
swarm/Monte-Carlo run is a `vmap` over this function (BASELINE.json
configs 1-4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.ops.integrators import integrate
from crazyflie_nmpc_tpu.solver import policies as policies_mod
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.rti import init_rti, rti_step


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Static closed-loop configuration.

    delay_steps: round-trip delay in control periods (reference default:
      60 ms / 15 ms = 4, acados_predictor.launch:62).  0 = ideal loop
      applying u0 with no prediction.
    plant_substeps: RK4 substeps for the simulated plant per tick (>= the
      controller's 1 for a finer 'true' plant).
    """

    delay_steps: int = dataclasses.field(default=0,
                                         metadata=dict(static=True))
    plant_substeps: int = dataclasses.field(default=1,
                                            metadata=dict(static=True))
    # delay predictor scheme:
    #   "pending"      — integrate the measurement forward under the
    #                    commands actually in flight (pipe-accurate; this
    #                    repo's default, see estimator_in_the_loop)
    #   "last_command" — the reference's scheme verbatim: one ZOH
    #                    integration of length delay under the last
    #                    published control (acados_estimator.cpp:573-593).
    #                    On the RAW rotor-speed plant this is
    #                    destabilizing at 60 ms (pinned in
    #                    tests/test_estimator_fidelity.py); it is the
    #                    right model only when the plant has an inner
    #                    attitude loop (see cmd_vel_loop).
    predictor: str = dataclasses.field(default="pending",
                                       metadata=dict(static=True))
    # hold-last-action on solver failure: a non-finite solve publishes the
    # previous command instead (the reference's failed-solve behavior —
    # the catch block keeps the last outputs, acados_mpc.cpp:714-717,
    # SURVEY.md §5 failure detection)
    guard_failures: bool = dataclasses.field(default=True,
                                             metadata=dict(static=True))
    # rematerialize each tick under reverse-mode AD (jax.checkpoint):
    # differentiating through a T-tick flight (runtime.tuning) stores O(T)
    # solver activations; remat stores only the per-tick carry and recomputes
    # the tick in the backward pass — the standard memory/FLOPs trade for
    # long-horizon gradients.  No effect on forward-only simulation cost.
    remat: bool = dataclasses.field(default=False,
                                    metadata=dict(static=True))
    # solver default = the CERTIFIED operating point (8 + mu-gated
    # escalation to 32): plain fixed-8 measurably degrades aggressive
    # transients (0.21 m trajectory divergence, +7% cost at 1.5 m —
    # tools/default_iters_flightcheck.py), and converged ticks pay
    # nothing for the guard (ipm.certified_config docstring).
    ipm: ipm.IPMConfig = dataclasses.field(
        default_factory=ipm.certified_config)


class LoopResult(NamedTuple):
    x: Any          # (T, nx) true plant states at each tick
    u: Any          # (T, nu) controls applied during [t, t+1)
    u_cmd: Any      # (T, nu) controls commanded at each tick
    kkt_res: Any    # (T,) solver residual per tick
    policy_mode: Any  # (T,) policy mode per tick


def simulate(spec: OCPSpec, x_init: jax.Array,
             policy_state: policies_mod.PolicyState,
             traj_table: jax.Array, steps: int,
             config: LoopConfig = LoopConfig(),
             measure=None) -> LoopResult:
    """Run `steps` ticks of the closed loop from `x_init`.

    With delay_steps = d > 0 the actuation path is modelled as a d-tick
    pipeline: the command issued at tick t reaches the rotors at tick t+d.
    The controller compensates exactly like the reference: it integrates the
    measured state d stages forward under the pending commands, solves from
    that predicted state, and emits u_d... pattern collapsed to the
    reference's 'predict by T=delay under the last applied control, then
    take u1' for d = 1-step actuation lag + measurement lag.

    measure: optional (state0, fn) measurement model with
      fn(state, x_plant) -> (state', x_measured).  None = ideal feedback
      (the controller sees the true plant state).  The estimator chain
      plugs in here (see estimator_in_the_loop).
    """
    if config.predictor not in ("pending", "last_command"):
        raise ValueError(
            f"LoopConfig.predictor must be 'pending' or 'last_command', "
            f"got {config.predictor!r}")
    d = config.delay_steps
    f = spec.ode()
    uss = spec.steady_input(x_init.dtype)

    rti0 = init_rti(spec, x_init)
    mstate0, measure_fn = measure if measure is not None else (None, None)
    # pending command pipeline: commands in flight (oldest first)
    u_pipe0 = jnp.broadcast_to(uss, (max(d, 1),) + uss.shape)

    def tick(carry, _):
        x_plant, rti_state, pol_state, u_pipe, u_prev, mstate = carry

        # --- reference generation (policy machine)
        yref, yref_e, pol_next = policies_mod.make_yref(
            spec, pol_state, traj_table)

        # --- measurement model: ideal feedback, or the estimator chain's
        # reconstruction of the state from raw sensor channels
        if measure_fn is None:
            x_meas = x_plant
        else:
            mstate, x_meas = measure_fn(mstate, x_plant)

        # --- delay-compensating state prediction (estimator predictor):
        # propagate the measurement forward by the round-trip delay under
        # the commands already in flight (acados_estimator.cpp:573-593).
        def predict(x):
            if d == 0:
                return x
            if config.predictor == "last_command":
                # acados_estimator.cpp:573-593: sim_in_set("T", delay),
                # sim_in_set("u", last acados_motvel), one solve
                return integrate(f, spec.params, x, u_prev,
                                 d * spec.dt, d * spec.sim_steps)

            def body(xc, u_k):
                return integrate(f, spec.params, xc, u_k, spec.dt,
                                 spec.sim_steps), None
            xp, _ = jax.lax.scan(body, x, u_pipe[:d])
            return xp

        x_pred = predict(x_meas)

        # --- RTI solve from the predicted state
        rti_new, out = rti_step(spec, rti_state, x_pred, yref, yref_e,
                                config.ipm)
        u_cmd = out.u0
        if config.guard_failures:
            # hold-last-action fallback: a non-finite solve keeps the
            # previous command and discards the broken iterate
            ok = jnp.all(jnp.isfinite(out.u_plan)) & jnp.all(
                jnp.isfinite(out.x_plan))
            u_cmd = jnp.where(ok, u_cmd, u_prev)
            rti_state = jax.tree.map(
                lambda new, old: jnp.where(ok, new, old), rti_new,
                rti_state)
        else:
            rti_state = rti_new

        # --- actuation: with delay, the plant runs the oldest pending
        # command while the new one enters the pipe.
        if d > 0:
            u_apply = u_pipe[0]
            u_pipe = jnp.concatenate([u_pipe[1:d], u_cmd[None]], axis=0)
        else:
            u_apply = u_cmd

        # --- plant step (finer substepping than the controller model)
        x_next = integrate(f, spec.params, x_plant, u_apply, spec.dt,
                           config.plant_substeps)

        carry = (x_next, rti_state, pol_next, u_pipe, u_cmd, mstate)
        outs = (x_plant, u_apply, u_cmd, out.kkt_res, pol_state.mode)
        return carry, outs

    carry0 = (x_init, rti0, policy_state, u_pipe0, uss, mstate0)
    tick_fn = jax.checkpoint(tick) if config.remat else tick
    _, (xs, us, ucmds, kkts, modes) = jax.lax.scan(
        tick_fn, carry0, None, length=steps)
    return LoopResult(x=xs, u=us, u_cmd=ucmds, kkt_res=kkts,
                      policy_mode=modes)


def tracking_error(res: LoopResult, traj_table) -> Any:
    """Per-tick position error over the TRACKING window of a loop result.

    The playhead advances one row per tick from 0, so the k-th tracking
    tick aligns with table row k; the window closes when the policy
    latches to Position_Hold.  One canonical implementation of the
    output-contract metric (used by tests, examples, and bringups).
    """
    import numpy as np

    track = np.asarray(res.policy_mode) == policies_mod.TRACKING
    n = int(track.sum())
    return np.linalg.norm(np.asarray(res.x)[track, :3]
                          - np.asarray(traj_table)[:n, :3], axis=1)


def hover_regulation(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                     steps=1320, config: LoopConfig = LoopConfig()):
    """BASELINE config 1: hover regulation closed loop (20 s at 66.6 Hz)."""
    pol = policies_mod.regulation_state(setpoint)
    ny = spec.cost.W.shape[0]
    dummy_table = jnp.zeros((1, ny), x_init.dtype)
    return simulate(spec, x_init, pol, dummy_table, steps, config)


def trajectory_tracking(spec: OCPSpec, x_init, traj_table, steps=None,
                        config: LoopConfig = LoopConfig()):
    """BASELINE config 2: precomputed-trajectory tracking (helix etc.)."""
    ny = spec.cost.W.shape[0]
    if spec.f is not None:
        # custom-model spec: the regulation setpoint is unused in TRACKING
        # mode but must have the full (ny,) layout to trace (policies.py)
        pol = policies_mod.tracking_state(
            setpoint=jnp.zeros((ny,), x_init.dtype))
    else:
        pol = policies_mod.tracking_state()
    steps = steps or traj_table.shape[0]
    return simulate(spec, x_init, pol, traj_table, steps, config)


def cmd_vel_loop(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                 steps: int = 660, delay_steps: int = 4,
                 config: LoopConfig = LoopConfig(), gains=None,
                 plant_substeps: int = 10, meas_delay_steps: int = 0,
                 predictor: str = "motvel", policy_state=None,
                 traj_table=None, measure=None):
    """The reference's ACTUAL actuation architecture, closed in software:

        NMPC (rotor-level internal model, u1/x4 extraction)
          -> to_cmd_vel                      (acados_mpc.cpp:644-670)
          -> radio pipe                      (actuation leg)
          -> onboard attitude/rate cascade   (models.firmware)
          -> rotor physics

    with the reference's OWN delay predictor — one ZOH integration of
    length delay_steps*dt under the last published motvel (u0,
    acados_estimator.cpp:573-593).  This is the configuration in which
    the single-last-command scheme is stable: the onboard inner loop
    absorbs the actuation mismatch that destabilizes the raw rotor-speed
    plant (pinned side by side in tests/test_estimator_fidelity.py).

    delay_steps is the TOTAL round-trip delay the predictor compensates
    (the reference's `delay` rosparam: sensing-to-actuation, 0.06 s = 4
    ticks at the shipped operating point, acados_predictor.launch:61-63).
    meas_delay_steps places that round trip physically: the NMPC's
    measurement is meas_delay_steps ticks stale (mocap processing +
    stream latency) and the command pipe is the remaining
    delay_steps - meas_delay_steps ticks (radio + firmware ingest).
    meas_delay_steps=0 (default) is the all-actuation worst case; the
    measured stability envelope over this split is pinned in
    tests/test_estimator_fidelity.py and swept by tools/firmware_envelope.py.

    predictor selects the single-last-command predictor's PLANT MODEL:
      "motvel"  — the reference verbatim: ZOH rotor-level integration
        under the last published acados_motvel (acados_estimator.cpp:
        578-586).  Faithful to the reference code, but its model omits
        the onboard cascade: during transients the published rotor plan
        and the mixer's actual output diverge, and the 60 ms prediction
        error compounds through the open-loop-unstable attitude
        dynamics — measured envelope in software: stable through
        delay_steps=2 across the whole (kp, kd, tau_m) gain grid
        (tools/firmware_envelope.py; 0/72 configs stable at 4).
      "cmd_vel" — the same single-last-command scheme with the MODEL-
        CONSISTENT plant: propagate through the onboard cascade
        (models.firmware) holding the last emitted cmd_vel — i.e.
        predict the drone doing what it actually does during the gap:
        tracking the last attitude command.  The estimator state is
        still only (measurement, last command); no pipe knowledge.
        This closes the reference's 60 ms operating point in software
        (pinned in tests/test_estimator_fidelity.py).

    policy_state / traj_table select the reference policy driving yref:
    None (default) = Regulation at `setpoint`; pass
    policies.tracking_state() + a 17-column table for Tracking — the
    reference's helix flight configuration (acados_mpc.cpp:458-488)
    through this exact actuation path (see flight_configuration).

    measure: optional (state0, fn) measurement model applied to the
    (possibly stale) plant state before prediction — plug in
    estimator_measurement for the full sensor chain (mocap LPF fusion,
    Euler-roundtripped attitude).  None = ideal feedback.

    Returns LoopResult: x = true plant states, u = rotor speeds the
    onboard mixer actually produced, u_cmd = the NMPC's published u0.
    """
    from crazyflie_nmpc_tpu.models.firmware import (
        AttitudeGains, attitude_plant_step, init_motor_state)
    from crazyflie_nmpc_tpu.solver.outputs import to_cmd_vel

    gains = gains if gains is not None else AttitudeGains()
    if predictor not in ("motvel", "cmd_vel"):
        raise ValueError(f"predictor must be 'motvel' or 'cmd_vel', "
                         f"got {predictor!r}")
    d = delay_steps
    dm = meas_delay_steps
    if not 0 <= dm <= d:
        raise ValueError(f"meas_delay_steps must be in [0, delay_steps], "
                         f"got {dm} with delay_steps={d}")
    da = d - dm                      # actuation-leg pipe depth
    f = spec.ode()
    uss = spec.steady_input(x_init.dtype)
    pol0 = (policy_state if policy_state is not None
            else policies_mod.regulation_state(setpoint))
    ny = spec.cost.W.shape[0]
    table = (jnp.asarray(traj_table, x_init.dtype)
             if traj_table is not None
             else jnp.zeros((1, ny), x_init.dtype))
    mstate0, measure_fn = measure if measure is not None else (None, None)
    rti0 = init_rti(spec, x_init)

    from crazyflie_nmpc_tpu.solver.outputs import krpm2pwm

    hover_cmd = jnp.array(
        [0.0, 0.0, 0.0, krpm2pwm(jnp.mean(uss))], x_init.dtype)
    cmd_pipe0 = jnp.broadcast_to(hover_cmd, (max(da, 1), 4))
    x_hist0 = jnp.broadcast_to(x_init, (max(dm, 1),) + x_init.shape)

    def tick(carry, _):
        (x_plant, rti_state, pol_state, cmd_pipe, x_hist, u_prev,
         cmd_prev, motor, mstate) = carry
        yref, yref_e, pol_next = policies_mod.make_yref(
            spec, pol_state, table)

        # measurement leg: the NMPC sees the dm-tick-stale plant state
        x_stale = x_hist[0] if dm > 0 else x_plant
        if dm > 0:
            x_hist = jnp.concatenate([x_hist[1:dm], x_plant[None]], axis=0)
        # sensor chain: the estimator's reconstruction of the (stale)
        # plant state from mocap + stabilizer Euler + gyro — the stream
        # itself is uniformly delayed, so fusion runs on the stale state
        if measure_fn is None:
            x_meas = x_stale
        else:
            mstate, x_meas = measure_fn(mstate, x_stale)

        # single-last-command predictor over the FULL round trip
        # (sensing staleness + actuation pipe)
        if d == 0:
            x_pred = x_meas
        elif predictor == "motvel":
            # the reference verbatim: ZOH rotor-level integration under
            # the last published motvel (acados_estimator.cpp:573-593)
            x_pred = integrate(f, spec.params, x_meas, u_prev,
                               d * spec.dt, max(d, 1) * spec.sim_steps)
        else:
            # model-consistent: the drone keeps tracking the last
            # attitude command through its onboard cascade
            def pred_body(xc, _):
                xn, _, _ = attitude_plant_step(
                    spec.params, xc, cmd_prev, spec.dt,
                    substeps=plant_substeps, gains=gains)
                return xn, None
            x_pred, _ = jax.lax.scan(pred_body, x_meas, None, length=d)

        rti_state, out = rti_step(spec, rti_state, x_pred, yref, yref_e,
                                  config.ipm)
        tw = to_cmd_vel(out.u1, out.x_at(4))
        cmd = jnp.stack([tw.roll_deg, tw.pitch_deg, tw.yawrate_deg,
                         tw.thrust_pwm])

        if da > 0:
            cmd_apply = cmd_pipe[0]
            cmd_pipe = jnp.concatenate([cmd_pipe[1:da], cmd[None]], axis=0)
        else:
            cmd_apply = cmd

        x_next, u_rotor, motor = attitude_plant_step(
            spec.params, x_plant, cmd_apply, spec.dt,
            substeps=plant_substeps, gains=gains, motor=motor)

        carry = (x_next, rti_state, pol_next, cmd_pipe, x_hist, out.u0,
                 cmd, motor, mstate)
        outs = (x_plant, u_rotor, out.u0, out.kkt_res, pol_state.mode)
        return carry, outs

    carry0 = (x_init, rti0, pol0, cmd_pipe0, x_hist0, uss, hover_cmd,
              init_motor_state(spec.params, x_init), mstate0)
    _, (xs, us, ucmds, kkts, modes) = jax.lax.scan(
        tick, carry0, None, length=steps)
    return LoopResult(x=xs, u=us, u_cmd=ucmds, kkt_res=kkts,
                      policy_mode=modes)


def estimator_measurement(spec: OCPSpec, x_init):
    """The reference estimator chain as a `simulate` measurement model.

    Reduces the true plant state to the raw sensor channels on the
    reference's wire — mocap position, stabilizer Euler attitude, gyro
    rates (acados_estimator.cpp:452-513) — then reassembles the 13-state:
    quaternion from Euler, 5-sample IIR-LPF position differentiation for
    world velocity (the reference filter's 0.7686 DC gain included),
    body-frame rotation.  Returns the (state0, fn) pair for
    simulate(..., measure=...).
    """
    from crazyflie_nmpc_tpu.estimator.pipeline import fuse, init_estimator
    from crazyflie_nmpc_tpu.models import rotations

    def fn(est, x_plant):
        return fuse(est, x_plant[:3],
                    rotations.quat_to_euler(x_plant[3:7]), x_plant[10:],
                    spec.dt)

    return init_estimator(spec.params, x_init[:3]), fn


def estimator_in_the_loop(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                          steps: int = 660, delay_steps: int = 4,
                          config: LoopConfig = LoopConfig(),
                          policy_state=None, traj_table=None):
    """Full-fidelity closed loop: the NMPC sees only the estimator chain's
    reconstruction of the plant (SURVEY §7 step 6's measurement-synthesis
    configuration) — `simulate` with `estimator_measurement` plugged in.

    `delay_steps` overrides config.delay_steps (the two are one knob: the
    actuation pipe the loop models and the horizon the controller
    predicts across).  Delay compensation integrates the MEASURED state
    forward under the commands actually in flight, per `simulate`.  The
    reference's single-last-command predictor
    (estimator.pipeline.predict, acados_estimator.cpp:573-593) is NOT
    used here: against this raw rotor-speed plant it is destabilizing at
    60 ms (measured: diverges) — on the real vehicle the onboard attitude
    loop absorbs that mismatch; in pure software the pipe-accurate
    predictor is the faithful analog.

    Quadrotor-only (the estimator layer is the reference's sensor
    pipeline).  Returns LoopResult with x = TRUE plant states.
    """
    cfg = dataclasses.replace(config, delay_steps=delay_steps)
    ny = spec.cost.W.shape[0]
    pol0 = (policy_state if policy_state is not None
            else policies_mod.regulation_state(setpoint))
    table = (jnp.asarray(traj_table, x_init.dtype)
             if traj_table is not None
             else jnp.zeros((1, ny), x_init.dtype))
    return simulate(spec, x_init, pol0, table, steps, cfg,
                    measure=estimator_measurement(spec, x_init))


def flight_configuration(spec: OCPSpec, traj_table, steps=None,
                         delay_steps: int = 4,
                         config: LoopConfig = LoopConfig(),
                         predictor: str = "cmd_vel", gains=None,
                         meas_delay_steps: int = 0,
                         plant_substeps: int = 10):
    """The reference's ACTUAL flight configuration, assembled end-to-end
    in ONE loop — every block the paper flew, composed (not spliced):

        helix Tracking policy          (acados_mpc.cpp:458-488)
          + full estimator chain        (mocap IIR-LPF velocity fusion,
            Euler-roundtripped attitude, acados_estimator.cpp:356-440)
          + 60 ms round-trip delay      (acados_predictor.launch:61-63;
            delay_steps=4 x 15 ms, split sensing/actuation via
            meas_delay_steps)
          + single-last-command delay predictor
                                        (acados_estimator.cpp:573-593)
          + u1/x4 -> cmd_vel extraction (acados_mpc.cpp:619-625,644-670)
          + onboard attitude cascade    (models.firmware — the firmware
            loop the cmd_vel contract targets)
          + rotor physics.

    predictor: "cmd_vel" (default) is the model-consistent single-last-
    command predictor — stable at the shipped 60 ms operating point and
    beyond (pinned in tests/test_flight_configuration.py).  "motvel" is
    the reference's rotor-level predictor verbatim; its measured envelope
    in software is delay_steps <= 2 (tools/firmware_envelope.py: 0/72
    gain configs stable at 4) — pass it with delay_steps<=2 to fly the
    literal reference scheme.

    Returns LoopResult (x = TRUE plant states); feed to tracking_error
    for the per-tick position error over the tracking window.
    """
    table = jnp.asarray(traj_table)
    x0 = table[0, :13]
    ny = spec.cost.W.shape[0]
    return cmd_vel_loop(
        spec, x0, steps=steps or table.shape[0], delay_steps=delay_steps,
        config=config, gains=gains, plant_substeps=plant_substeps,
        meas_delay_steps=meas_delay_steps, predictor=predictor,
        policy_state=policies_mod.tracking_state(
            setpoint=jnp.zeros((ny,), table.dtype) if spec.f is not None
            else (0.0, 0.0, 0.5)),
        traj_table=table, measure=estimator_measurement(spec, x0))
