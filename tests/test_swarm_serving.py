"""Swarm serving: ONE batched solve fanned out to N wire vehicles.

VERDICT r4 item 3: the reference's defining multi-drone server — N
Crazyflies, one thread + NMPC node each (crazyflie_server.cpp:155,
1108-1131, multi_hover_*.launch) — re-expressed as a single
`rti_step_batched` launch whose batch axis is the vehicle axis, with
telemetry returning into a batched estimator and per-vehicle cmd_vel +
deadline accounting through the native link (runtime/swarm.py).

The convergence test flies 8 vehicles from the ground to a formation
grid through the REAL wire (UDP/CRTP both directions, cascade-plant
firmware endpoints) in lockstep time.
"""

import numpy as np

from crazyflie_nmpc_tpu.runtime.swarm import grid_targets

N_VEHICLES = 8
BASE_PORT = 47410


def test_grid_targets_formation():
    t = grid_targets(8, spacing=0.5, z=0.4)
    assert t.shape == (8, 3)
    assert np.allclose(t[:, 2], 0.4)
    # centered formation, all slots distinct
    assert np.allclose(t[:, :2].mean(axis=0), 0.0, atol=1e-12)
    assert len({tuple(r) for r in np.round(t, 9).tolist()}) == 8
    # neighbor spacing respected along the grid rows
    assert np.isclose(t[1, 0] - t[0, 0], 0.5)


def test_numpy_rotation_twins_match_jax():
    """The firmware sim's pure-numpy rotation/thrust helpers (no eager
    JAX in vehicle threads) match models.rotations / solver.outputs."""
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.models import rotations as rot
    from crazyflie_nmpc_tpu.native.hl_executor import (
        _PWM_OFFSET,
        _PWM_SCALE,
        _quat_to_euler_np,
        _rotmat_body_to_earth_np,
    )
    from crazyflie_nmpc_tpu.solver.outputs import krpm2pwm

    rng = np.random.default_rng(3)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(
            _quat_to_euler_np(q),
            np.asarray(rot.quat_to_euler(jnp.asarray(q))), atol=1e-7)
        np.testing.assert_allclose(
            _rotmat_body_to_earth_np(q),
            np.asarray(rot.rotmat_body_to_earth(jnp.asarray(q))),
            atol=1e-7)
    w = 17.3
    np.testing.assert_allclose((w * 1e3 - _PWM_OFFSET) / _PWM_SCALE,
                               float(krpm2pwm(w)), rtol=1e-9)


def test_cascade_sim_arms_on_thrust():
    """CascadeFirmwareSim: motors stay off below the arm threshold (the
    vehicle-side thrust-lock gate), fly above it."""
    from crazyflie_nmpc_tpu import native

    with native.CascadeFirmwareSim(BASE_PORT + 80) as fw:
        z0 = fw.x[2]
        fw.last_setpoint = (0.0, 0.0, 0.0, 0.0)   # the 100-zero unlock
        for _ in range(20):
            fw.poll(15)
        assert not fw.flying and fw.x[2] == z0
        # hover-ish thrust arms and lifts
        fw.last_setpoint = (0.0, 0.0, 0.0, 48000.0)
        for _ in range(40):
            fw.poll(15)
        assert fw.flying
        assert fw.x[2] > z0


def test_swarm_converges_over_wire():
    """8 vehicles, one batched device solve per tick, through the link:
    every vehicle reaches its formation slot; telemetry stays fresh;
    per-vehicle deadline accounting is populated."""
    from crazyflie_nmpc_tpu import bringup

    out = bringup.swarm_serving(n=N_VEHICLES, ticks=220,
                                base_port=BASE_PORT)
    rep = out["report"]
    assert rep.n_vehicles == N_VEHICLES
    assert rep.latency_s.shape == (220, N_VEHICLES)

    # the multi-drone behavior: every vehicle converges to ITS slot
    assert rep.final_err_m.max() < 0.08, rep.final_err_m
    # slots are distinct — the solve really served N different problems
    final_pos = rep.positions[-1]
    assert np.linalg.norm(final_pos[:, None] - final_pos[None, :],
                          axis=-1)[np.triu_indices(N_VEHICLES, 1)].min() \
        > 0.3
    # telemetry plane: fresh rows on ~every tick after bringup
    assert (rep.staleness[5:] <= 1).mean() > 0.99
    # accounting is per-vehicle and sane
    misses = rep.deadline_misses(budget_s=rep.period_s)
    assert misses.shape == (N_VEHICLES,)
    assert np.isfinite(rep.latency_s).all()


def test_swarm_fused_path_matches_vmap():
    """The batched swarm step (rti_step_batched, batch-last layout,
    per-lane yref) produces the same commands as the vmap path on
    identical telemetry — the wiring bench.py's swarm row rides, pinned
    without hardware."""
    import jax
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import bringup
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.runtime.swarm import SwarmNMPC, grid_targets
    from crazyflie_nmpc_tpu.solver import default_ocp

    bringup._jax_cpu()
    spec = default_ocp(dtype=jnp.float32)
    targets = grid_targets(5, spacing=0.5, z=0.4)
    cfg = IPMConfig(iters=2)

    key = jax.random.PRNGKey(7)
    x0s = np.asarray(
        0.05 * jax.random.normal(key, (5, 13), jnp.float32), np.float64)
    x0s[:, :3] += targets * np.array([1.0, 1.0, 0.2])
    x0s[:, 3] = 1.0
    mocap = x0s[:, :3].copy()
    euler = np.asarray(5.0 * jax.random.normal(
        jax.random.fold_in(key, 1), (5, 3), jnp.float32), np.float64)
    gyro = np.asarray(10.0 * jax.random.normal(
        jax.random.fold_in(key, 2), (5, 3), jnp.float32), np.float64)

    cmds = {}
    for label, kw in (("fused", dict(use_fused=True)),
                      ("vmap", dict(use_fused=False))):
        sw = SwarmNMPC(spec, targets, ipm_config=cfg, **kw)
        sw.reset(x0s)
        cmd, u_apply = sw.step(mocap, euler, gyro)
        cmds[label] = (cmd, u_apply)
        assert cmd.shape == (5, 4) and u_apply.shape == (5, 4)

    # same estimator + same QP, two solver paths: agreement to f32-
    # rounding-amplified-by-conditioning (the pod-parity tolerance)
    np.testing.assert_allclose(cmds["fused"][0][:, :3],
                               cmds["vmap"][0][:, :3], atol=0.02)
    np.testing.assert_allclose(cmds["fused"][0][:, 3],
                               cmds["vmap"][0][:, 3], rtol=1e-3)
    np.testing.assert_allclose(cmds["fused"][1], cmds["vmap"][1],
                               rtol=1e-3, atol=5e-3)


def test_swarm_realtime_discipline():
    """lockstep=False: endpoints serve real time, the host loop runs on
    the TickScheduler (absolute-time schedule).  This pins the
    DISCIPLINE — schedule kept, per-vehicle accounting populated,
    telemetry live, vehicles flying under the streamed commands — with
    a lighter OCP (N=20, iters=4) so a contended 2-vCPU CI host can
    hold the 20 Hz period.  Closed-loop CONVERGENCE through the wire is
    pinned by the lockstep tests at the 66.6 Hz design rate (the
    cmd_vel architecture is unstable when its 15 ms command is held
    ~200 ms, matching the delay-envelope study — off-design-rate
    convergence is deliberately NOT asserted here)."""
    import contextlib

    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import bringup, native
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.runtime.swarm import SwarmNMPC, serve_swarm
    from crazyflie_nmpc_tpu.solver import default_ocp

    bringup._jax_cpu()
    n = 2
    rate_hz = 20.0
    spec = default_ocp(N=20, tf=0.3, dtype=jnp.float32)
    targets = np.array([[0.0, 0.0, 0.4], [0.6, 0.0, 0.4]])
    swarm = SwarmNMPC(spec, targets, use_fused=False,
                      tick_dt=1.0 / rate_hz,
                      ipm_config=IPMConfig(iters=4))
    with contextlib.ExitStack() as stack:
        fws = []
        for i in range(n):
            fw = native.CascadeFirmwareSim(
                BASE_PORT + 40 + 2 * i,
                x0=(targets[i, 0], targets[i, 1], 0.03))
            stack.enter_context(fw)
            fw.serve()
            fws.append(fw)
        server = stack.enter_context(native.LinkServer())
        for i in range(n):
            server.add_vehicle(i + 1, "127.0.0.1", BASE_PORT + 40 + 2 * i,
                               BASE_PORT + 40 + 2 * i + 1)
        rep = serve_swarm(spec, server, [1, 2], fws, swarm, ticks=80,
                          rate_hz=rate_hz, lockstep=False)
    assert rep.latency_s.shape == (80, n)
    assert np.isfinite(rep.latency_s).all()
    # every vehicle armed and FLEW under the streamed commands
    assert (rep.positions[:, :, 2].max(axis=0) > 0.2).all(), \
        rep.positions[:, :, 2].max(axis=0)
    # telemetry stayed live in real time
    assert (rep.staleness[-20:] <= 3).mean() > 0.8
    # the absolute-time schedule was mostly held (slips are counted,
    # not forbidden — CI hosts jitter)
    assert rep.schedule_slips < 40


def test_swarm_vehicles_track_independent_targets():
    """A 3-vehicle asymmetric formation: per-lane yref really steers
    each lane (not one shared reference)."""
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import bringup, native
    from crazyflie_nmpc_tpu.runtime.swarm import SwarmNMPC, serve_swarm
    from crazyflie_nmpc_tpu.solver import default_ocp

    bringup._jax_cpu()
    import contextlib

    spec = default_ocp(dtype=jnp.float32)
    targets = np.array([[0.0, 0.0, 0.3], [0.8, 0.0, 0.5],
                        [0.0, -0.6, 0.7]])
    swarm = SwarmNMPC(spec, targets, use_fused=False)
    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(native.CascadeFirmwareSim(
            BASE_PORT + 60 + 2 * i, x0=(targets[i, 0], targets[i, 1],
                                        0.03)))
            for i in range(3)]
        server = stack.enter_context(native.LinkServer())
        for i in range(3):
            server.add_vehicle(i + 1, "127.0.0.1", BASE_PORT + 60 + 2 * i,
                               BASE_PORT + 60 + 2 * i + 1)
        rep = serve_swarm(spec, server, [1, 2, 3], fws, swarm, ticks=220)
    # each vehicle is at ITS height, not a common one
    z = np.array([fw.x[2] for fw in fws])
    np.testing.assert_allclose(z, targets[:, 2], atol=0.06)
    assert rep.final_err_m.max() < 0.08
