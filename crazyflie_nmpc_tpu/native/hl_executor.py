"""Flying firmware sim: a high-level-commander EXECUTOR behind the link.

VERDICT r4 item 4: the wire path (upload_trajectory / start_trajectory /
takeoff / land over CRTP) previously only *stored and acked* on the
vehicle side (firmware_sim.py records `hl_commands` + `trajectory_mem`
with no motion), while the flying path (MissionClient -> NMPC tracking)
never crossed the link.  This module closes the loop the way the real
firmware does (crazyflie_server.cpp:920-992 services; the onboard
high-level commander + Mellinger controller the reference's
test_high_level.py:13-23 and joystick.py:16-20 enable):

    CRTP HL command -> planner (min-jerk segments / uploaded poly4d
    pieces, uav_trajectory.py:54-84 math) -> geometric position
    controller -> cmd_vel attitude command -> onboard cascade
    (models.firmware.attitude_plant_step) -> rigid-body physics

so `bringup.high_level_mission` produces MOTION, and the flown figure8
can be asserted against the Polynomial4D evaluation
(tests/test_hl_flight.py).

The planner follows firmware semantics: each new HL command preempts the
current one; `start_trajectory(relative=True)` shifts the polynomial so
it starts at the current position; `land` cuts motors at its end; poly4d
pieces are decoded from the trajectory memory exactly as uploaded by
`LinkServer.upload_trajectory` (utils.trajectories.encode_poly4d wire
format — the crazyflie_cpp poly4d layout).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from crazyflie_nmpc_tpu.native.firmware_sim import FirmwareSim

GRAVITY = 9.8066
# thrust map constants (solver.outputs, acados_mpc.cpp:421-425)
_PWM_SCALE = 0.2685
_PWM_OFFSET = 4070.3


def _quat_to_euler_np(q):
    """numpy twin of models.rotations.quat_to_euler (same algebra as the
    reference's quatern2euler, acados_mpc.cpp:384-404).  The firmware
    sim's telemetry/controller paths run in per-vehicle THREADS at
    10-15 ms cadence — eager JAX dispatch there contends with the main
    thread's solver dispatch (measured: it throttled the N-vehicle
    realtime loop), so the vehicle side is pure numpy."""
    qw, qx, qy, qz = q
    r11 = 2 * (qw * qw + qx * qx) - 1
    r21 = 2 * (qx * qy - qw * qz)
    r31 = 2 * (qx * qz + qw * qy)
    r32 = 2 * (qy * qz - qw * qx)
    r33 = 2 * (qw * qw + qz * qz) - 1
    return np.array([math.atan2(r32, r33),
                     -math.asin(min(max(r31, -1.0), 1.0)),
                     math.atan2(r21, r11)])


def _rotmat_body_to_earth_np(q):
    """numpy twin of models.rotations.rotmat_body_to_earth."""
    qw, qx, qy, qz = q
    s = np.array([
        [2 * (qw * qw + qx * qx) - 1, 2 * (qx * qy + qw * qz),
         2 * (qx * qz - qw * qy)],
        [2 * (qx * qy - qw * qz), 2 * (qw * qw + qy * qy) - 1,
         2 * (qy * qz + qw * qx)],
        [2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx),
         2 * (qw * qw + qz * qz) - 1]])
    return s.T


@functools.lru_cache(maxsize=None)
def _cached_plant_step(params, gains, plant_dt_ms: int, substeps: int):
    """One jitted cascade-plant step shared across vehicle instances.

    Keyed on the (hashable, frozen) physical parameters — a swarm of N
    simulated vehicles with identical hardware compiles ONCE instead of
    once per endpoint."""
    import jax
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.models.firmware import attitude_plant_step

    dt = jnp.float32(plant_dt_ms / 1000.0)
    return jax.jit(
        lambda x, cmd, motor: attitude_plant_step(
            params, x, cmd, dt, substeps=substeps, gains=gains,
            motor=motor))


class _MinJerk:
    """Min-jerk point-to-point segment (quintic), per axis + yaw."""

    def __init__(self, p0, p1, yaw0, yaw1, duration):
        self.p0 = np.asarray(p0, np.float64)
        self.d = np.asarray(p1, np.float64) - self.p0
        self.yaw0 = float(yaw0)
        self.dyaw = float(yaw1) - self.yaw0
        self.T = max(float(duration), 1e-3)

    def __call__(self, t):
        s = min(max(t / self.T, 0.0), 1.0)
        b = 10 * s**3 - 15 * s**4 + 6 * s**5
        db = (30 * s**2 - 60 * s**3 + 30 * s**4) / self.T
        ddb = (60 * s - 180 * s**2 + 120 * s**3) / self.T**2
        return dict(pos=self.p0 + self.d * b, vel=self.d * db,
                    acc=self.d * ddb,
                    yaw=self.yaw0 + self.dyaw * b,
                    dyaw=self.dyaw * db)

    @property
    def duration(self):
        return self.T


class _Poly4D:
    """Uploaded piecewise polynomial, evaluated with the time-warp
    semantics of the firmware's timescale (f(t/ts): velocities scale by
    1/ts, accelerations by 1/ts^2)."""

    def __init__(self, durations, coeffs, shift, timescale, reversed_):
        self.durations = np.asarray(durations, np.float64)
        self.coeffs = np.asarray(coeffs, np.float64).copy()
        if reversed_:
            # time-reverse each piece about its duration and flip order
            self.coeffs = self.coeffs[::-1]
            self.durations = self.durations[::-1]
            rev = []
            for dur, c in zip(self.durations, self.coeffs):
                rev.append(np.stack([_shift_poly(c[a][::-1].copy(), dur)
                                     for a in range(4)]))
            self.coeffs = np.stack(rev)
        self.coeffs[:, 0, 0] += shift[0]
        self.coeffs[:, 1, 0] += shift[1]
        self.coeffs[:, 2, 0] += shift[2]
        self.ts = max(float(timescale), 1e-3)
        self.starts = np.concatenate([[0.0], np.cumsum(self.durations)[:-1]])
        self.total = float(self.durations.sum())

    def __call__(self, t):
        tau = min(max(t / self.ts, 0.0), self.total - 1e-9)
        i = int(np.clip(np.searchsorted(self.starts, tau, side="right") - 1,
                        0, len(self.durations) - 1))
        tt = tau - self.starts[i]
        c0 = self.coeffs[i]
        c1 = _polyder_np(c0)
        c2 = _polyder_np(c1)
        f0 = _polyval_np(c0, tt)
        f1 = _polyval_np(c1, tt) / self.ts
        f2 = _polyval_np(c2, tt) / self.ts**2
        return dict(pos=f0[:3], vel=f1[:3], acc=f2[:3],
                    yaw=f0[3], dyaw=f1[3])

    @property
    def duration(self):
        return self.total * self.ts


def _polyval_np(c, t):
    r = np.zeros(c.shape[0]) + c[:, -1]
    for i in range(c.shape[1] - 2, -1, -1):
        r = r * t + c[:, i]
    return r


def _polyder_np(c):
    return c[:, 1:] * np.arange(1, c.shape[1])


def _shift_poly(c_desc, dur):
    """Coefficients of p(dur - t) given p's lowest-first coeffs reversed
    (c_desc is highest-first); returns lowest-first."""
    # p(dur - t): expand via binomial; small (degree 7), do it numerically
    n = len(c_desc)
    c = c_desc[::-1]             # lowest-first original
    out = np.zeros(n)
    for k in range(n):           # term c[k] (dur - t)^k
        for j in range(k + 1):
            out[j] += c[k] * math.comb(k, j) * dur**(k - j) * (-1.0)**j
    return out


class FlyingFirmwareSim(FirmwareSim):
    """FirmwareSim + plant + high-level-commander executor.

    The vehicle sits on the ground (motors off) until a takeoff command;
    thereafter every HL command is flown through the position controller
    and the onboard attitude cascade (models.firmware).  Time advances
    with `poll(dt_ms)` — tests fast-forward by polling manually;
    `serve()` runs real-time like the base class.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 x0=(0.0, 0.0, 0.03), plant_dt_ms: int = 15,
                 substeps: int = 10, gains=None,
                 kp_pos=(6.0, 6.0, 8.0), kv_pos=(4.0, 4.0, 5.0),
                 kp_yaw: float = 4.0):
        super().__init__(port, host, state_provider=self._log_value)
        import jax
        import jax.numpy as jnp

        from crazyflie_nmpc_tpu.models.firmware import (
            AttitudeGains,
            init_motor_state,
        )
        from crazyflie_nmpc_tpu.models.quadrotor import QuadrotorParams as _QP

        self.quad_params = _QP()
        self.gains = gains or AttitudeGains()
        self.kp_pos = np.asarray(kp_pos, np.float64)
        self.kv_pos = np.asarray(kv_pos, np.float64)
        self.kp_yaw = float(kp_yaw)
        self.plant_dt = plant_dt_ms / 1000.0
        self._plant_dt_ms = plant_dt_ms
        self._accum_ms = 0

        x = np.zeros(13)
        x[0:3] = x0
        x[3] = 1.0
        self.x = x                      # rigid-body state, numpy f64 view
        self.flying = False
        self.segment = None             # active planner segment
        self.seg_t0_ms = 0
        self.seg_is_landing = False
        self.flown = []                 # (t_s, x(13)) history while flying
        self._cmd_idx = 0
        # HL-commander group membership (the SetGroupMask service,
        # crazyflie_server.cpp:911-916): a command addressed to group
        # g != 0 executes only on vehicles whose mask has bit g set;
        # g == 0 addresses everyone (the firmware broadcast semantics)
        self.group_mask = 0

        self._jx = jax
        # vehicle physics always runs on the HOST backend: in a process
        # whose default device is an accelerator, the swarm's
        # batched solve belongs there but N simulated plants do not —
        # each would pay the host<->device round trip per tick
        self._cpu = jax.local_devices(backend="cpu")[0]
        self._step_fn = _cached_plant_step(
            self.quad_params, self.gains, plant_dt_ms, substeps)
        with jax.default_device(self._cpu):
            self._motor = init_motor_state(
                self.quad_params, jnp.asarray(x, jnp.float32))

    # ---- telemetry ------------------------------------------------------

    def _log_value(self, name: str) -> float:
        x = self.x
        if name.startswith("stateEstimate."):
            return float(x["xyz".index(name[-1])])
        if name.startswith("gyro."):
            return float(math.degrees(x[10 + "xyz".index(name[-1])]))
        if name.startswith("stabilizer."):
            eu = _quat_to_euler_np(x[3:7])
            return float(math.degrees(
                eu[["roll", "pitch", "yaw"].index(name.split(".")[1])]))
        if name.startswith("motor.m"):
            return float(np.asarray(self._motor[0])[int(name[-1]) - 1])
        if name == "pm.vbat":
            return 3.9
        return 0.0

    # ---- planner --------------------------------------------------------

    def _consume_commands(self):
        cmds = self.hl_commands
        while self._cmd_idx < len(cmds):
            c = cmds[self._cmd_idx]
            self._cmd_idx += 1
            self._activate(c)

    def _activate(self, c):
        pos = self.x[0:3].copy()
        yaw = self._yaw()
        name = c["cmd"]
        if name == "set_group_mask":
            self.group_mask = int(c["group"])
            return
        # group filter (firmware semantics): group 0 = everyone; a
        # nonzero group executes only if this vehicle is a member
        g = int(c.get("group", 0))
        if g != 0 and not (g & self.group_mask):
            return
        if name == "takeoff":
            tgt = np.array([pos[0], pos[1], c["height"]])
            tyaw = yaw if c.get("use_current_yaw", True) else c.get("yaw",
                                                                    yaw)
            self.segment = _MinJerk(pos, tgt, yaw, tyaw, c["duration"])
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
            self.flying = True
        elif name == "land":
            tgt = np.array([pos[0], pos[1], max(c["height"], 0.03)])
            self.segment = _MinJerk(pos, tgt, yaw, yaw, c["duration"])
            self.seg_is_landing = True
            self.seg_t0_ms = self.time_ms
        elif name == "go_to" and self.flying:
            goal = np.array([c["x"], c["y"], c["z"]])
            if c.get("relative"):
                goal = pos + goal
            self.segment = _MinJerk(pos, goal, yaw, c["yaw"], c["duration"])
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
        elif name == "start_trajectory" and self.flying:
            tid = c["traj_id"]
            if tid not in self.trajectories:
                return
            off, n_pieces = self.trajectories[tid]
            from crazyflie_nmpc_tpu.utils.trajectories import decode_poly4d
            durations, coeffs = decode_poly4d(
                bytes(self.trajectory_mem[off:off + 132 * n_pieces]),
                n_pieces)
            shift = (pos - np.array([coeffs[0, 0, 0], coeffs[0, 1, 0],
                                     coeffs[0, 2, 0]])
                     if c.get("relative") else np.zeros(3))
            self.segment = _Poly4D(durations, coeffs, shift,
                                   c.get("timescale", 1.0),
                                   c.get("reversed", False))
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
        elif name == "stop":
            self.segment = None
            self.flying = False

    def _yaw(self) -> float:
        return -float(_quat_to_euler_np(self.x[3:7])[2])  # body-axis yaw

    # ---- executor -------------------------------------------------------

    def poll(self, dt_ms: int = 1):
        super().poll(dt_ms)
        self._consume_commands()
        self._accum_ms += dt_ms
        while self._accum_ms >= self._plant_dt_ms:
            self._accum_ms -= self._plant_dt_ms
            self._physics_tick()

    def _physics_tick(self):
        if not self.flying:
            return
        t = (self.time_ms - self.seg_t0_ms) / 1000.0
        seg = self.segment
        if seg is None:
            return
        ref = seg(t)
        if t > seg.duration and self.seg_is_landing:
            # touchdown: motors off, firmware-style
            self.flying = False
            self.segment = None
            self.x[2] = min(self.x[2], 0.04)
            self.x[7:13] = 0.0
            return
        cmd = self._position_controller(ref)
        jnp = self._jx.numpy
        with self._jx.default_device(self._cpu):
            x_next, _, self._motor = self._step_fn(
                jnp.asarray(self.x, jnp.float32),
                jnp.asarray(cmd, jnp.float32), self._motor)
        self.x = np.asarray(x_next, np.float64)
        self.flown.append((self.time_ms / 1000.0, self.x.copy()))

    def _position_controller(self, ref):
        """Geometric (Mellinger-style) position loop -> cmd_vel.

        acc_cmd = acc_ref + Kp e_p + Kv e_v + g zhat; desired attitude
        from the thrust axis + yaw (the uav_trajectory.py:70-84 frame
        construction); thrust = m acc_cmd . z_body through the
        krpm2pwm map the cascade inverts (solver.outputs)."""
        x = self.x
        R = _rotmat_body_to_earth_np(x[3:7])
        vel_world = R @ x[7:10]

        acc_cmd = (ref["acc"] + self.kp_pos * (ref["pos"] - x[0:3])
                   + self.kv_pos * (ref["vel"] - vel_world)
                   + np.array([0.0, 0.0, GRAVITY]))
        nrm = np.linalg.norm(acc_cmd)
        z_body_des = acc_cmd / max(nrm, 1e-6)
        x_world = np.array([math.cos(ref["yaw"]), math.sin(ref["yaw"]), 0.0])
        y_body = np.cross(z_body_des, x_world)
        y_body /= max(np.linalg.norm(y_body), 1e-9)
        x_body = np.cross(y_body, z_body_des)
        Rd = np.stack([x_body, y_body, z_body_des], axis=-1)
        qw = 0.5 * math.sqrt(max(1.0 + Rd[0, 0] + Rd[1, 1] + Rd[2, 2],
                                 1e-12))
        qd = np.array([qw, (Rd[2, 1] - Rd[1, 2]) / (4 * qw),
                       (Rd[0, 2] - Rd[2, 0]) / (4 * qw),
                       (Rd[1, 0] - Rd[0, 1]) / (4 * qw)])
        eu_d = _quat_to_euler_np(qd)
        alpha_des, beta_des = -eu_d[0], -eu_d[1]

        # thrust along the CURRENT body z (geometric-controller projection)
        f_acc = max(float(acc_cmd @ R[:, 2]), 0.5)
        w_cmd = math.sqrt(self.quad_params.mq * f_acc
                          / (4.0 * self.quad_params.Ct))
        pwm = (w_cmd * 1000.0 - _PWM_OFFSET) / _PWM_SCALE

        yaw_err = ref["yaw"] - self._yaw()
        yaw_err = (yaw_err + math.pi) % (2 * math.pi) - math.pi
        yawrate = math.degrees(self.kp_yaw * yaw_err + ref["dyaw"])

        return np.array([math.degrees(alpha_des), -math.degrees(beta_des),
                         yawrate, np.clip(pwm, 0.0, 60000.0)])


class CascadeFirmwareSim(FlyingFirmwareSim):
    """FirmwareSim + cascade plant flown by raw cmd_vel setpoints.

    The firmware's LOW-LEVEL mode: no onboard planner — each received
    attitude setpoint (roll/pitch deg, yaw rate deg/s, thrust PWM;
    the reference's cmd_vel contract, acados_mpc.cpp:644-670) is held
    and tracked by the onboard attitude/rate cascade
    (models.firmware.attitude_plant_step) driving rigid-body physics.
    This is the vehicle endpoint `runtime.swarm` fans a batched NMPC
    solve out to: what a real Crazyflie does when the reference server
    forwards /crazyflie/cmd_vel over the radio
    (crazyflie_server.cpp:155,1108-1131 per-vehicle loops).

    Arming follows the firmware's thrust-lock discipline: the vehicle
    sits on the ground, motors off, until a setpoint with thrust above
    `arm_thrust_pwm` arrives (the unlock-after-zero sequence is the
    link server's job; this is the vehicle-side gate).
    """

    ARM_THRUST_PWM = 1000.0

    def _consume_commands(self):
        # low-level mode: the HL planner is inert; commands are recorded
        # (base-class behavior) but never flown
        pass

    def _physics_tick(self):
        sp = self.last_setpoint
        if sp is None:
            return
        if not self.flying:
            if sp[3] < self.ARM_THRUST_PWM:
                return
            self.flying = True
        cmd = np.array([sp[0], sp[1], sp[2], sp[3]], np.float64)
        jnp = self._jx.numpy
        with self._jx.default_device(self._cpu):
            x_next, _, self._motor = self._step_fn(
                jnp.asarray(self.x, jnp.float32),
                jnp.asarray(cmd, jnp.float32), self._motor)
        x_next = np.asarray(x_next, np.float64)
        if x_next[2] <= 0.0:           # ground: no tunneling below z=0
            x_next[2] = 0.0
            x_next[9] = max(x_next[9], 0.0)
        self.x = x_next
        self.flown.append((self.time_ms / 1000.0, self.x.copy()))
