"""Named bringup compositions — the launch-file layer as code.

The reference composes its stack with ~40 roslaunch files (SURVEY.md
§2.1/§2.4).  Here each headline bringup is a named function that wires the
same components together and runs them; `python -m crazyflie_nmpc_tpu.bringup
<name>` is the `roslaunch` equivalent.  Mapping:

| reference launch                  | bringup here            |
|-----------------------------------|-------------------------|
| acados_predictor.launch           | nmpc_predictor          |
| crazy_AFL.launch (fake mocap)     | nmpc_attitude_bench     |
| crazyflie2.launch + demo.py       | pid_waypoints           |
| system_identification.launch      | system_identification   |
| hover.launch / Hover.py           | hover_demo              |
| position.launch / Position.py     | position_demo           |
| multi_hover_*.launch              | multi_hover             |
| teleop_*.launch                   | teleop                  |

Each returns a plain dict of results so callers/tests can assert on them.
Bringups that exercise the radio path spin up the native link server
against the firmware simulator on localhost UDP — the same seam a real
Crazyradio bridge would occupy.
"""

from __future__ import annotations

import numpy as np


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from crazyflie_nmpc_tpu.utils.cache import setup_compilation_cache

    setup_compilation_cache()
    return jax


def nmpc_predictor(steps: int = 660, delay: float = 0.06,
                   traj: str = "helix", f64: bool = True,
                   actuation: str = "cmd_vel"):
    """acados_predictor.launch: the full NMPC pipeline — tracking the helix
    reference with the delay-compensating estimator at delay=0.06 s
    (acados_predictor.launch:56-65).

    actuation selects the command path out of the controller:
      "cmd_vel" (default) — the configuration the reference actually
        flew, composed end-to-end: u1/x4 -> cmd_vel -> radio pipe ->
        onboard attitude cascade, with the model-consistent single-
        last-command predictor (runtime.flight_configuration; pinned at
        2.3 cm max by tests/test_flight_configuration.py).
      "rotor" — device-resident rotor-level actuation with the
        pipe-accurate pending-commands predictor
        (runtime.estimator_in_the_loop; 1.9 cm max).
    """
    jax = _jax_cpu()
    if f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.runtime import (
        LoopConfig,
        estimator_in_the_loop,
        flight_configuration,
        tracking_error,
    )
    from crazyflie_nmpc_tpu.solver import default_ocp, policies
    from crazyflie_nmpc_tpu.utils import (
        helix_trajectory,
        smooth_step_trajectory,
    )

    dtype = jnp.float64 if f64 else jnp.float32
    spec = default_ocp(dtype=dtype)
    table = (helix_trajectory(spec.params) if traj == "helix"
             else smooth_step_trajectory(spec.params)).astype(dtype)
    delay_steps = int(round(delay / float(spec.dt)))
    cfg = LoopConfig(ipm=IPMConfig(iters=8))
    steps = min(int(steps), table.shape[0] - 1)
    if actuation == "cmd_vel":
        # the paper's flight configuration in ONE loop: estimator chain +
        # cmd_vel extraction + radio delay + onboard cascade
        res = flight_configuration(spec, table, steps=steps,
                                   delay_steps=delay_steps, config=cfg)
    elif actuation == "rotor":
        # full-fidelity rotor-level variant: the estimator node's
        # reconstruction feeds the NMPC, rotor commands ride the pipe
        res = estimator_in_the_loop(
            spec, jnp.asarray(table[0, :13]), steps=steps,
            delay_steps=delay_steps, config=cfg,
            policy_state=policies.tracking_state(), traj_table=table)
    else:
        raise ValueError(f"actuation must be 'cmd_vel' or 'rotor', "
                         f"got {actuation!r}")
    err = tracking_error(res, table)
    return {"result": res, "tracking_err_max": float(err.max()),
            "kkt_max": float(np.max(np.asarray(res.kkt_res))),
            "delay_steps": delay_steps, "actuation": actuation}


def nmpc_attitude_bench(steps: int = 300, port: int = 47051,
                        bag_path: str | None = None):
    """crazy_AFL.launch: the NMPC bench against the *fake* mocap bridge
    (constant origin at 10 Hz) with cmd_vel recorded at the device side —
    the reference's full-pipeline smoke test (crazy_AFL.launch:33-89,
    publish_external_position_fake.py:14-24).  Like the reference launch,
    the run can record a bag of the streamed topics (rosbag record of
    cmd_vel/euler/openloop, crazy_AFL.launch:64-72) via `bag_path`."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.demo import FakeMocapBridge
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.solver import (
        default_ocp,
        hover_yref,
        init_rti,
        rti_step,
        to_cmd_vel,
    )

    spec = default_ocp(dtype=jnp.float32)
    # regulation set-point at the fake mocap's origin: bench expects a
    # level-attitude, hover-thrust response
    yref, yref_e = hover_yref(spec, pos=(0.0, 0.0, 0.0))
    step = jax.jit(lambda s, x: rti_step(spec, s, x, yref, yref_e,
                                         IPMConfig(iters=8)))
    cmd_vel_log = []
    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        bridge = FakeMocapBridge(server, 1, sleep=lambda _dt: None)

        # "motors disarmed": the state fed to the NMPC is the fake-mocap
        # origin-at-rest state; the controller's attitude/thrust response
        # is what the bench records.
        x_hat = hover_state(spec.params, dtype=jnp.float32)
        rti = init_rti(spec, x_hat)
        for _ in range(steps):
            bridge.step()
            rti, out = step(rti, x_hat)
            cmd = to_cmd_vel(out.u1, out.x_at(4))
            server.send_setpoint(1, float(cmd.roll_deg),
                                 float(cmd.pitch_deg),
                                 float(cmd.yawrate_deg),
                                 int(cmd.thrust_pwm))
            cmd_vel_log.append((float(cmd.roll_deg), float(cmd.pitch_deg),
                                float(cmd.yawrate_deg),
                                int(cmd.thrust_pwm)))
        import time

        deadline = time.time() + 2.0
        while fw.last_setpoint is None and time.time() < deadline:
            time.sleep(0.01)
        stats = server.stats(1)
        device_setpoint = fw.last_setpoint
        mocap_published = bridge.published
    if bag_path:
        from crazyflie_nmpc_tpu.runtime.bag import BagWriter

        cmd_arr = np.asarray(cmd_vel_log, np.float64)
        ts = float(spec.dt) * np.arange(len(cmd_arr))
        with BagWriter(bag_path) as w:
            w.write_series("cmd_vel", ts, cmd_arr)
    return {"cmd_vel": np.asarray(cmd_vel_log), "link_stats": stats,
            "device_setpoint": device_setpoint,
            "mocap_published": mocap_published}


def bag_play(bag_path: str, channel: str | None = None):
    """bag_play.launch + test_rosbag.launch: replay a recorded flight bag
    in time order and summarize each channel (the rqt_plot inspection
    step, bag_play.launch:1-31, test_rosbag.launch:1-18)."""
    from crazyflie_nmpc_tpu.runtime.bag import Bag

    bag = Bag(bag_path)
    names = [channel] if channel else bag.names()
    n_events = sum(1 for _ in bag.play(names))
    return {"summary": bag.summary(), "events_replayed": n_events,
            "channels": names}


def pid_waypoints(goals=None, max_steps: int = 4000):
    """crazyflie2.launch + demo.py: PID waypoint navigation with the
    0.3 m / 10 deg advance rule, on the grounded plant."""
    _jax_cpu()
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import pid as pidm
    from crazyflie_nmpc_tpu.demo import WaypointSequencer
    from crazyflie_nmpc_tpu.models import (
        QuadrotorParams,
        dynamics,
        hover_state,
        rotations,
    )
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu.solver.outputs import pwm2krpm

    goals = goals or [(0.0, 0.0, 0.6, 0.0, 0.2), (0.0, 0.0, 0.9, 0.0, 0.2)]
    dt = 0.02  # 50 Hz (controller.cpp:254)
    params = QuadrotorParams()
    gains = pidm.default_gains(jnp.float32)
    st = pidm.init_pid()
    x = hover_state(params, pos=(0.0, 0.0, 0.0), dtype=jnp.float32)
    st = pidm.takeoff(st, x[2])

    goal_box = {"g": goals[0][:4]}
    seq = WaypointSequencer(goals,
                            lambda *g: goal_box.__setitem__("g", g))
    visited = []
    t = 0.0
    for k in range(max_steps):
        rpy = rotations.quat_to_euler(x[3:7])
        alive = seq.tick((float(x[0]), float(x[1]), float(x[2]),
                          float(rpy[2])), t)
        visited.append(seq.index)
        if not alive:
            break
        gx, gy, gz, gyaw = goal_box["g"]
        st, cmd = pidm.pid_step(gains, st, x,
                                jnp.array([gx, gy, gz], jnp.float32),
                                gyaw, dt)
        krpm = jnp.clip(pwm2krpm(cmd.thrust), 0.0, 22.0)
        u = jnp.full((4,), krpm)
        x_next = rk4_step(dynamics, params, x, u, dt)
        on_ground = (x_next[2] <= 0.0) & (x_next[9] <= 0.0)
        x = jnp.where(on_ground, x_next.at[2].set(0.0).at[9].set(0.0),
                      x_next)
        t += dt
    return {"waypoints_reached": max(visited) + (0 if alive else 1),
            "n_goals": len(goals), "completed": not alive,
            "final_z": float(x[2]), "steps": k + 1}


def system_identification(steps: int = 400, port: int = 47053):
    """system_identification.launch: stream motor + state logs at 100 Hz
    through the link and assemble the sysid measurement table
    (measurements_vector.cpp pipeline + log blocks at 10 ms)."""
    _jax_cpu()
    import struct
    import time

    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.estimator.sysid import assemble_measurements
    from crazyflie_nmpc_tpu.models import (
        QuadrotorParams,
        dynamics,
        hover_state,
        rotations,
    )
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step

    params = QuadrotorParams()
    dt = 0.01  # 100 Hz stream (system_identification.launch:33-40)
    # plant: gentle torque-balanced climb from hover (open-loop stable
    # enough over 4 s)
    x = hover_state(params, dtype=jnp.float32)
    uss = float(params.hover_speed())

    plant = {"x": x, "k": 0}

    def provider(name):
        xs = plant["x"]
        rpy = rotations.quat_to_euler(xs[3:7])
        table = {
            "stateEstimate.x": float(xs[0]), "stateEstimate.y": float(xs[1]),
            "stateEstimate.z": float(xs[2]),
            "stabilizer.roll": float(jnp.rad2deg(rpy[0])),
            "stabilizer.pitch": float(jnp.rad2deg(rpy[1])),
            "stabilizer.yaw": float(jnp.rad2deg(rpy[2])),
            "gyro.x": float(jnp.rad2deg(xs[10])),
            "gyro.y": float(jnp.rad2deg(xs[11])),
            "gyro.z": float(jnp.rad2deg(xs[12])),
            "motor.m1": uss, "motor.m2": uss, "motor.m3": uss,
            "motor.m4": uss,
        }
        return table.get(name, 0.0)

    with native.FirmwareSim(port, state_provider=provider).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        pos_ids = [fw.log_vars[n][0] for n in
                   ("stateEstimate.x", "stateEstimate.y", "stateEstimate.z")]
        att_ids = [fw.log_vars[n][0] for n in
                   ("stabilizer.roll", "stabilizer.pitch", "stabilizer.yaw")]
        gyr_ids = [fw.log_vars[n][0] for n in
                   ("gyro.x", "gyro.y", "gyro.z")]
        server.log_create_block(1, 1, [(7, i) for i in pos_ids])
        server.log_create_block(1, 2, [(7, i) for i in att_ids])
        server.log_create_block(1, 3, [(7, i) for i in gyr_ids])
        for bid in (1, 2, 3):
            server.log_start_block(1, bid, 1)  # 10 ms period

        rows = {1: [], 2: [], 3: []}
        deadline = time.time() + 20.0
        while (min(len(v) for v in rows.values()) < steps
               and time.time() < deadline):
            rec = server.poll_log(1)
            if rec is None:
                # advance the plant at the stream rate
                plant["x"] = rk4_step(dynamics, params, plant["x"],
                                      jnp.full((4,), uss), dt)
                time.sleep(0.001)
                continue
            if rec["block_id"] in rows and len(rec["payload"]) >= 12:
                rows[rec["block_id"]].append(
                    struct.unpack("<fff", rec["payload"][:12]))
        n = min(len(v) for v in rows.values())
        positions = np.asarray(rows[1][:n])
        eulers = np.deg2rad(np.asarray(rows[2][:n]))
        gyros = np.deg2rad(np.asarray(rows[3][:n]))
    meas = assemble_measurements(jnp.asarray(positions),
                                 jnp.asarray(eulers), jnp.asarray(gyros),
                                 dt=0.01)
    return {"measurements": np.asarray(meas), "rows": n}


def thrust_identification(steps: int = 100, port: int = 47054,
                          thrust_pwm: int = 12000):
    """thrust_identification.launch + const_thrust.py: stream a constant
    cmd_vel thrust (const_thrust.py:16-18, 50 Hz) while logging the motor
    PWM echo at 10 ms (thrust_identification.launch:26-35) — the capture
    used offline to fit the krpm2pwm map (acados_mpc.cpp:421-425)."""
    import struct
    import time

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.solver.outputs import pwm2krpm

    sim = {}

    def provider(name):
        # a real CF at level attitude echoes the commanded thrust on all
        # four motors — that echo is exactly what the launch file records
        fw = sim.get("fw")
        sp = fw.last_setpoint if fw else None
        if name.startswith("motor.m") and sp is not None:
            return float(sp[3])
        return 0.0

    with native.FirmwareSim(port, state_provider=provider).serve() as fw, \
            native.LinkServer() as server:
        sim["fw"] = fw
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        motor_ids = [fw.log_vars[f"motor.m{i}"][0] for i in range(1, 5)]
        server.log_create_block(1, 1, [(7, i) for i in motor_ids])
        server.log_start_block(1, 1, 1)  # 10 ms

        rows = []
        next_sp = 0.0
        deadline = time.time() + 20.0
        while len(rows) < steps and time.time() < deadline:
            now = time.time()
            if now >= next_sp:  # 50 Hz constant-thrust stream
                server.send_setpoint(1, 0.0, 0.0, 0.0, thrust_pwm)
                next_sp = now + 0.02
            rec = server.poll_log(1)
            if rec is None:
                time.sleep(0.001)
                continue
            if rec["block_id"] == 1 and len(rec["payload"]) >= 16:
                rows.append(struct.unpack("<ffff", rec["payload"][:16]))
        pwm = np.asarray(rows).reshape(-1, 4)
        # drop rows streamed before the first setpoint landed
        pwm = pwm[np.any(pwm > 0, axis=1)]
    return {"rows": len(pwm), "motor_pwm": pwm,
            "commanded_pwm": thrust_pwm,
            "implied_krpm": float(pwm2krpm(float(pwm.mean())))
            if len(pwm) else float("nan")}


def high_level_mission(port: int = 47056):
    """test_high_level.py FLOWN over the wire: enable the high-level
    commander + Mellinger controller + EKF via params, then takeoff →
    upload a polynomial trajectory → startTrajectory → land → stop —
    with the vehicle side EXECUTING every command through the onboard
    cascade (native.FlyingFirmwareSim), so the mission produces motion,
    not just acks (test_high_level.py:13-23,50;
    crazyflie_server.cpp:920-992; uav_trajectory.py:54-84).

    Wire phases run under the firmware's real-time serve loop; flight
    phases fast-forward simulated time, so the whole mission returns in
    seconds.  Returns the command log, the params, and flight evidence:
    flown tick count, max tracking error vs the Polynomial4D evaluation,
    and the final (landed) position."""
    import time

    import numpy as np

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.utils import trajectories as traj

    def minjerk_piece(p0, p1, T):
        """Quintic min-jerk segment as one poly4d piece (4, 8)."""
        c = np.zeros((4, 8))
        for a in range(3):
            d = p1[a] - p0[a]
            c[a, 0] = p0[a]
            c[a, 3] = 10 * d / T**3
            c[a, 4] = -15 * d / T**4
            c[a, 5] = 6 * d / T**5
        return c

    durations = np.array([2.0, 2.0])
    coeffs = np.stack([
        minjerk_piece((0.0, 0.0, 0.0), (0.4, 0.2, 0.1), 2.0),
        minjerk_piece((0.4, 0.2, 0.1), (0.0, 0.0, 0.0), 2.0)])

    with native.FlyingFirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        toc = server.download_param_toc(1)
        for name, v in [("commander/enHighLevel", 1),
                        ("stabilizer/estimator", 2),
                        ("stabilizer/controller", 2),
                        ("kalman/resetEstimation", 1)]:
            server.set_param(1, toc[name][0], v, ptype="uint8")
        server.upload_trajectory(
            1, traj_id=1, data=traj.encode_poly4d(durations, coeffs),
            n_pieces=2)

        def wire(send, pred, timeout=5.0):
            ok = send()
            deadline = time.time() + timeout
            while time.time() < deadline and not pred():
                time.sleep(0.005)
            return ok and pred()

        def fly(ms):
            fw.stop_serving()
            for _ in range(ms // 15):
                fw.poll(15)
            fw.serve()

        cmds = fw.hl_commands
        has = lambda c: any(k["cmd"] == c for k in cmds)
        ok = wire(lambda: server.takeoff(1, height=0.5, duration=2.0),
                  lambda: has("takeoff") and 1 in fw.trajectories)
        fly(2600)
        start_pos = fw.x[:3].copy()
        ok &= wire(lambda: server.start_trajectory(1, 1, relative=True),
                   lambda: has("start_trajectory"))
        t0_ms = fw.seg_t0_ms
        fly(4400)
        # flown path vs the Polynomial4D evaluation (shifted to the
        # relative start), the uav_trajectory.py math
        errs = []
        for t, x in fw.flown:
            tau = t - t0_ms / 1000.0
            if 0.0 <= tau <= 4.0:
                f = traj.eval_flat_outputs(durations, coeffs, tau)
                exp = np.asarray(f["pos"]) + (start_pos - coeffs[0, :3, 0])
                errs.append(float(np.abs(x[:3] - exp).max()))
        ok &= wire(lambda: server.land(1, height=0.0, duration=2.0),
                   lambda: has("land"))
        fly(2600)
        ok &= wire(lambda: server.hl_stop(1), lambda: has("stop"))
        return {"hl_commands": list(cmds),
                "wire_ok": bool(ok),
                "params": {n: fw.get_param(n) for n in
                           ("commander/enHighLevel", "stabilizer/estimator",
                            "stabilizer/controller",
                            "kalman/resetEstimation")},
                "flown_ticks": len(fw.flown),
                "max_tracking_err_m": max(errs) if errs else None,
                "final_pos": [round(float(v), 4) for v in fw.x[:3]],
                "landed": not fw.flying}


def hover_demo(port: int = 47055):
    """hover.launch + Hover.py through the real link + firmware sim."""
    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.demo import HoverDemo

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        demo = HoverDemo(server, 1, sleep=lambda dt: __import__(
            "time").sleep(min(dt, 0.002)))
        demo.take_off(0.4)
        demo.go_to(0.2, 0.0, 0.4)
        demo.land()
        import time

        deadline = time.time() + 2.0
        while time.time() < deadline:
            sp = fw.last_generic_setpoint
            if sp and sp["type"] == "stop":
                break
            time.sleep(0.01)
        return {"final_setpoint": fw.last_generic_setpoint,
                "stats": server.stats(1)}


def position_demo(port: int = 47057):
    """position.launch + Position.py through the link + firmware sim."""
    import time

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.demo import position_demo as run_position

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        sent = run_position(server, 1, target=(0.0, 0.0, 0.4),
                            sleep=lambda dt: time.sleep(min(dt, 0.002)),
                            kalman_reset_param=fw.param_ids[
                                "kalman/resetEstimation"])
        deadline = time.time() + 2.0
        while time.time() < deadline:
            sp = fw.last_generic_setpoint
            if sp and sp["type"] == "stop":
                break
            time.sleep(0.01)
        return {"setpoints_sent": len(sent),
                "final_setpoint": fw.last_generic_setpoint}


def multi_hover(n: int = 2, base_port: int = 47060):
    """multi_hover_*.launch: N vehicles, one hover plan per thread."""
    import contextlib

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.demo.hover import run_two_vehicle_demo

    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(
            native.FirmwareSim(base_port + 2 * i).serve())
            for i in range(n)]
        server = stack.enter_context(native.LinkServer())
        for i in range(n):
            server.add_vehicle(i + 1, "127.0.0.1", base_port + 2 * i,
                               base_port + 2 * i + 1)
        demos = run_two_vehicle_demo(
            server, vids=tuple(range(1, n + 1)),
            sleep=lambda dt: __import__("time").sleep(min(dt, 0.001)))
        return {"vehicles": n,
                "landed": all(d.z_distance == 0.0 for d in demos),
                "stats": [server.stats(i + 1) for i in range(n)]}


def swarm_serving(n: int = 8, ticks: int = 260, base_port: int = 47090,
                  rate_hz: float = 66.6, spacing: float = 0.6,
                  z: float = 0.4, lockstep: bool = True,
                  use_fused: bool | None = None):
    """The multi-drone server as ONE batched solve: N cascade-plant
    vehicles behind the link, a single `rti_step_batched` launch per
    tick with per-vehicle formation references, cmd_vel fanned out per
    vehicle, telemetry returning into a batched estimator, per-vehicle
    deadline accounting (crazyflie_server.cpp:155,1108-1131 — the
    reference runs one NMPC node per drone; here the vehicle axis is
    the batch axis).  See runtime/swarm.py.

    use_fused: None lets SwarmNMPC choose (the batched path on a GPU);
    False runs the vmapped path on the CPU backend."""
    if use_fused is False:
        _jax_cpu()
    import contextlib

    import jax.numpy as jnp

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.runtime.swarm import (
        SwarmNMPC,
        grid_targets,
        serve_swarm,
    )
    from crazyflie_nmpc_tpu.solver import default_ocp

    spec = default_ocp(dtype=jnp.float32)
    targets = grid_targets(n, spacing=spacing, z=z)
    swarm = SwarmNMPC(spec, targets, use_fused=use_fused,
                      tick_dt=1.0 / rate_hz)

    with contextlib.ExitStack() as stack:
        fws = []
        for i in range(n):
            fw = native.CascadeFirmwareSim(
                base_port + 2 * i,
                x0=(targets[i, 0], targets[i, 1], 0.03),
                plant_dt_ms=max(1, int(round(1000.0 / rate_hz))))
            stack.enter_context(fw)
            if not lockstep:
                fw.serve()
            fws.append(fw)
        server = stack.enter_context(native.LinkServer())
        vids = list(range(1, n + 1))
        for i, vid in enumerate(vids):
            server.add_vehicle(vid, "127.0.0.1", base_port + 2 * i,
                               base_port + 2 * i + 1)
        report = serve_swarm(spec, server, vids, fws, swarm, ticks,
                             rate_hz=rate_hz, lockstep=lockstep)
        stats = [server.stats(vid) for vid in vids]
    return {"report": report, "summary": report.summary(),
            "targets": targets, "link_stats": stats}


def teleop(ticks: int = 50, port: int = 47070):
    """teleop_*.launch: joystick axis mapping streaming cmd_vel at 100 Hz
    (axes scripted — no joystick hardware in this environment)."""
    import time

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.demo import Teleop

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        tele = Teleop(server, 1, axes_source=lambda: (0.1, -0.1, 0.0, 0.2),
                      sleep=lambda dt: time.sleep(min(dt, 0.001)))
        tele.run(ticks)
        deadline = time.time() + 2.0
        while fw.last_setpoint is None and time.time() < deadline:
            time.sleep(0.01)
        return {"device_setpoint": fw.last_setpoint,
                "stats": server.stats(1)}


def telemetry(seconds: float = 1.2, port: int = 47080):
    """The reference server's typed telemetry plane on connect
    (crazyflie_server.cpp:519-651): instance the imu (10 ms) and
    mag/baro/battery + rssi (100 ms) blocks against a simulated vehicle
    and return the latest unit-converted channels."""
    import time

    from crazyflie_nmpc_tpu import native

    state = {"gyro.x": 5.0, "gyro.y": -2.0, "gyro.z": 0.5,
             "acc.x": 0.01, "acc.y": -0.02, "acc.z": 1.0,
             "mag.x": 2.2e-5, "mag.y": 0.4e-5, "mag.z": 4.3e-5,
             "baro.temp": 25.0, "baro.pressure": 1013.25,
             "pm.vbat": 3.95, "radio.rssi": -52.0}
    with native.FirmwareSim(port, state_provider=lambda n:
                            state.get(n, 0.0)).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", port, port + 1)
        toc = server.download_log_toc(1)
        layout = native.start_typed_channels(server, 1, toc)
        latest, counts = {}, {}
        deadline = time.time() + seconds
        while time.time() < deadline:
            rec = server.poll_log(1)
            if rec is None:
                time.sleep(0.002)
                continue
            ch = native.decode_channels(rec, layout)
            if ch is not None:
                latest[rec["block_id"]] = ch
                counts[rec["block_id"]] = counts.get(rec["block_id"],
                                                     0) + 1
        native.stop_typed_channels(server, 1, layout)
        return {"channels": {f"0x{bid:X}": ch
                             for bid, ch in latest.items()},
                "records": {f"0x{bid:X}": n for bid, n in counts.items()}}


def session(panes):
    """The reference's tmux workbench, re-expressed
    (crazyflie_demo/scripts/tmux_create_panes + tmux_openinpane +
    tmux_clear_panes): several nodes running side by side in one
    session.  Here a "pane" is a named bringup composition run on its
    own thread; the session starts them together, joins them all, and
    returns per-pane results (the C-c-everything teardown of
    tmux_clear_panes is the join — bringups are finite compositions,
    not daemons).

    panes: {pane_name: (bringup_name, *args)}.  Bringups that open UDP
    endpoints must be given distinct ports (as distinct tmux panes
    would).  Returns {pane_name: result-or-exception}.
    """
    import threading

    results = {}

    def run_pane(pane, name, args):
        try:
            results[pane] = BRINGUPS[name](*args)
        except Exception as e:          # a crashed pane must not take
            results[pane] = e           # down the session (tmux semantics)

    threads = [
        threading.Thread(target=run_pane, args=(pane, spec[0], spec[1:]),
                         name=f"pane-{pane}", daemon=True)
        for pane, spec in panes.items()
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


BRINGUPS = {
    "nmpc_predictor": nmpc_predictor,
    "telemetry": telemetry,
    "nmpc_attitude_bench": nmpc_attitude_bench,
    "pid_waypoints": pid_waypoints,
    "system_identification": system_identification,
    "thrust_identification": thrust_identification,
    "high_level_mission": high_level_mission,
    "hover_demo": hover_demo,
    "position_demo": position_demo,
    "multi_hover": multi_hover,
    "swarm_serving": swarm_serving,
    "teleop": teleop,
    "bag_play": bag_play,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="crazyflie_nmpc_tpu.bringup")
    ap.add_argument("name", choices=sorted(BRINGUPS))
    ap.add_argument("extra", nargs="*",
                    help="positional args for the composition "
                         "(e.g. the bag path for bag_play)")
    args = ap.parse_args(argv)
    out = BRINGUPS[args.name](*args.extra)
    for k, v in out.items():
        if isinstance(v, np.ndarray):
            v = f"array{v.shape}"
        elif hasattr(v, "_fields") or str(type(v)).startswith(
                "<class 'crazyflie"):
            v = type(v).__name__
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
