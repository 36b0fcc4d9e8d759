"""Swarm serving: ONE batched device solve fanned out to N wire vehicles.

The reference's defining server architecture is a multi-drone hub — N
Crazyflies, one thread + callback queue each, every vehicle running its
own NMPC node (crazyflie_server.cpp:155,1108-1131; the multi_hover_*
launch files).  The batched answer inverts that: the batch axis IS the
vehicle axis.  Each tick, every vehicle's telemetry (mocap position +
stabilizer Euler + gyro, the acados_estimator.cpp:452-513 channel set)
crosses the link into one (B, ·) array, a single `rti_step_batched`
launch solves all B optimal-control problems on the device, and B
cmd_vel commands fan back out through the native link server — so adding
a vehicle costs one more lane in a batched solve, not one more solver
process.

Pipeline per tick (all device work inside ONE jit):

    telemetry (B,3)x3  ->  batched estimator fuse          (estimator.
                           pipeline.fuse, vmapped: Euler->quat, IIR-LPF
                           velocity differentiation, body-frame rotation)
                       ->  model-consistent delay predictor (d wire ticks
                           through the onboard cascade under each
                           vehicle's last cmd_vel — the same scheme
                           flight_configuration pins at the reference's
                           60 ms operating point)
                       ->  rti_step_batched with PER-VEHICLE yref
                           (each lane regulates to its own formation
                           target — (B, N, ny) reference support)
                       ->  u1/x4 -> cmd_vel                 (acados_mpc.
                           cpp:619-625,644-670)

`SwarmNMPC` owns the compiled step; `serve_swarm` binds it to a
`LinkServer` + N `CascadeFirmwareSim` endpoints with per-vehicle
deadline accounting (`SwarmReport`).  Two time disciplines:

  * lockstep (default): vehicle physics advance exactly one tick period
    per host tick under manual `poll()` — deterministic, sleep-free, and
    still crossing the real UDP/CRTP wire both ways.  Used by tests.
  * realtime: endpoints run their own serve threads; the host loop runs
    on a `TickScheduler` at the configured rate (the serving.py
    discipline) — used by bench.py's swarm-over-the-wire row.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from crazyflie_nmpc_tpu.estimator.pipeline import fuse, init_estimator
from crazyflie_nmpc_tpu.models.firmware import (
    AttitudeGains,
    attitude_plant_step,
)
from crazyflie_nmpc_tpu.ops.backend import sweep_backend
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec, hover_yref
from crazyflie_nmpc_tpu.solver.outputs import krpm2pwm, to_cmd_vel
from crazyflie_nmpc_tpu.solver.rti import RTIState, init_rti, rti_step
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched


class SwarmNMPC:
    """The device side: one compiled batched NMPC step for B vehicles.

    targets: (B, 3) formation hover positions — lane b's yref regulates
    vehicle b to targets[b] (the per-problem (B, N, ny) reference path
    of rti_step_batched).
    """

    def __init__(self, spec: OCPSpec, targets,
                 ipm_config: Optional[IPMConfig] = None,
                 delay_steps: int = 1, use_fused: Optional[bool] = None,
                 gains: AttitudeGains = AttitudeGains(),
                 predict_substeps: int = 4,
                 tick_dt: Optional[float] = None):
        """tick_dt: the REAL interval between telemetry samples (= the
        serving period).  The estimator's velocity differentiation and
        the delay predictor's integration step must use the actual
        sample spacing, not the model's 15 ms stage dt — at the
        reference's 66.6 Hz they coincide, but a floor-derated serving
        rate with the default dt overestimates velocity by
        period/0.015x and destabilizes the loop (measured in the
        realtime swarm test).  None = spec.dt (the 66.6 Hz contract)."""
        targets = np.asarray(targets, np.float64)
        self.spec = spec
        self.batch = B = targets.shape[0]
        self.targets = targets
        if use_fused is None:
            # the batched path wherever its sweep kernel runs
            use_fused = sweep_backend() == "kernel"
        self.use_fused = use_fused
        if ipm_config is None:
            ipm_config = certified_config(
                capacity=min(B, 256) if use_fused else 0)
        self.ipm_config = ipm_config
        d = int(delay_steps)

        # per-vehicle regulation references
        yrefs, yref_es = [], []
        for b in range(B):
            yr, ye = hover_yref(
                spec, pos=tuple(float(v) for v in targets[b]))
            yrefs.append(yr)
            yref_es.append(ye)
        self._yref = jnp.stack(yrefs)            # (B, N, ny)
        self._yref_e = jnp.stack(yref_es)        # (B, nx)

        params = spec.params
        dt = float(tick_dt) if tick_dt is not None else float(spec.dt)
        self.tick_dt = dt
        # keep the cascade-prediction substep near the 1.5 ms the
        # envelope study validated, whatever the tick period
        substeps = max(predict_substeps, int(round(dt / 0.004)))

        def _fuse_all(est, mocap, euler_deg, gyro_deg):
            return jax.vmap(
                lambda e, p, eu, gy: fuse(e, p, jnp.deg2rad(eu),
                                          jnp.deg2rad(gy), dt)
            )(est, mocap, euler_deg, gyro_deg)

        def _predict(x, cmd_prev):
            """d wire ticks ahead through the onboard cascade holding
            each vehicle's last cmd_vel (the model-consistent single-
            last-command predictor, closed_loop.cmd_vel_loop)."""
            def body(xc, _):
                xn = jax.vmap(
                    lambda xi, ci: attitude_plant_step(
                        params, xi, ci, dt, substeps=substeps,
                        gains=gains)[0]
                )(xc, cmd_prev)
                return xn, None
            xp, _ = jax.lax.scan(body, x, None, length=d)
            return xp

        if use_fused:
            kw = dict(config=ipm_config, layout="batch_last")

            def _step(carry, mocap, euler_deg, gyro_deg):
                est, states, cmd_prev = carry
                est, x = _fuse_all(est, mocap, euler_deg, gyro_deg)
                x = _predict(x, cmd_prev)
                states, out = rti_step_batched(
                    self.spec, states, x, self._yref, self._yref_e, **kw)
                tw = to_cmd_vel(out.u_plan[1].T, out.x_plan[4].T)
                u_apply = out.u_plan[0].T                      # (B, nu)
                cmd = jnp.stack([tw.roll_deg, tw.pitch_deg,
                                 tw.yawrate_deg, tw.thrust_pwm], axis=-1)
                return (est, states, cmd), cmd, u_apply, out.kkt_res
        else:
            vstep = jax.vmap(
                lambda s, x, yr, ye: rti_step(self.spec, s, x, yr, ye,
                                              ipm_config),
                in_axes=(0, 0, 0, 0))

            def _step(carry, mocap, euler_deg, gyro_deg):
                est, states, cmd_prev = carry
                est, x = _fuse_all(est, mocap, euler_deg, gyro_deg)
                x = _predict(x, cmd_prev)
                states, out = vstep(states, x, self._yref, self._yref_e)
                tw = to_cmd_vel(out.u_plan[:, 1], out.x_plan[:, 4])
                u_apply = out.u_plan[:, 0]
                cmd = jnp.stack([tw.roll_deg, tw.pitch_deg,
                                 tw.yawrate_deg, tw.thrust_pwm], axis=-1)
                return (est, states, cmd), cmd, u_apply, out.kkt_res

        self._step = jax.jit(_step, donate_argnums=(0,))
        self._carry = None

    def reset(self, x0s: np.ndarray):
        """(Re)initialize warm starts, estimator filters, and the held
        hover cmd_vel from (B, nx) vehicle states."""
        x0s = jnp.asarray(np.asarray(x0s, np.float32))
        st = jax.vmap(lambda x: init_rti(self.spec, x))(x0s)
        if self.use_fused:
            st = RTIState(x_traj=jnp.moveaxis(st.x_traj, 0, -1),
                          u_traj=jnp.moveaxis(st.u_traj, 0, -1))
        est = jax.vmap(
            lambda x: init_estimator(self.spec.params, x[:3]))(x0s)
        uss = self.spec.steady_input(jnp.float32)
        hover_cmd = jnp.array([0.0, 0.0, 0.0,
                               krpm2pwm(jnp.mean(uss))], jnp.float32)
        cmd0 = jnp.broadcast_to(hover_cmd, (self.batch, 4))
        self._carry = (est, st, cmd0)

    def step(self, mocap, euler_deg, gyro_deg):
        """One serving tick: (B,3) telemetry arrays -> (B,4) cmd_vel
        rows [roll deg, pitch deg, yawrate deg/s, thrust PWM] + (B,nu)
        rotor plan row 0 (the motvel loopback) — numpy."""
        if self._carry is None:
            raise RuntimeError("call reset() before step()")
        args = [jnp.asarray(np.asarray(a, np.float32))
                for a in (mocap, euler_deg, gyro_deg)]
        self._carry, cmd, u_apply, kkt = self._step(self._carry, *args)
        cmd, u_apply = jax.device_get((cmd, u_apply))
        return np.asarray(cmd), np.asarray(u_apply)


@dataclasses.dataclass
class SwarmReport:
    """Per-vehicle serving evidence for a swarm run."""

    n_vehicles: int
    ticks: int
    period_s: float
    #: (ticks, B) per-vehicle emit latency: setpoint-on-the-wire instant
    #: minus that tick's telemetry-gather start
    latency_s: np.ndarray
    #: (ticks, B) telemetry freshness: ticks since each vehicle's state
    #: row was last updated when the solve consumed it (0 = fresh)
    staleness: np.ndarray
    #: (B,) final |position - target| per vehicle [m]
    final_err_m: np.ndarray
    #: (ticks, B) per-vehicle positions (from telemetry)
    positions: np.ndarray
    schedule_slips: int = 0

    def deadline_misses(self, budget_s: float) -> np.ndarray:
        """(B,) count of ticks whose emit latency exceeded the budget."""
        return (self.latency_s > budget_s).sum(axis=0)

    def summary(self, budget_s: Optional[float] = None) -> dict:
        budget = self.period_s if budget_s is None else budget_s
        lat = self.latency_s
        return dict(
            n_vehicles=self.n_vehicles, ticks=self.ticks,
            rate_hz=1.0 / self.period_s,
            p50_ms=1e3 * float(np.percentile(lat, 50)),
            p99_ms=1e3 * float(np.percentile(lat, 99)),
            worst_vehicle_miss=int(self.deadline_misses(budget).max()),
            total_misses=int(self.deadline_misses(budget).sum()),
            stale_ticks=int((self.staleness > 0).sum()),
            final_err_max_m=float(self.final_err_m.max()),
            schedule_slips=self.schedule_slips,
        )


class _TelemetryPlane:
    """Per-vehicle log blocks -> (B,3) mocap/euler/gyro arrays.

    Creates the three 12-byte blocks the estimator consumes
    (stateEstimate.*, stabilizer.*, gyro.* — acados_estimator.cpp:
    452-513) on every vehicle at the 10 ms firmware granularity, and
    drains them into latest-value rows with staleness accounting.
    """

    BLOCKS = {1: ("stateEstimate.x", "stateEstimate.y", "stateEstimate.z"),
              2: ("stabilizer.roll", "stabilizer.pitch", "stabilizer.yaw"),
              3: ("gyro.x", "gyro.y", "gyro.z")}

    def __init__(self, server, vids, fws):
        self.server = server
        self.vids = list(vids)
        B = len(self.vids)
        self.mocap = np.zeros((B, 3), np.float64)
        self.euler = np.zeros((B, 3), np.float64)
        self.gyro = np.zeros((B, 3), np.float64)
        self.last_update = np.full((B,), -1, np.int64)
        for b, (vid, fw) in enumerate(zip(self.vids, fws)):
            self.mocap[b] = fw.x[:3]
            for bid, names in self.BLOCKS.items():
                ids = [fw.log_vars[n][0] for n in names]
                server.log_create_block(vid, bid, [(7, i) for i in ids])
                server.log_start_block(vid, bid, 1)      # 10 ms period

    def drain(self, tick: int) -> None:
        """Ingest every pending log record into the latest-value rows."""
        arrays = {1: self.mocap, 2: self.euler, 3: self.gyro}
        for b, vid in enumerate(self.vids):
            while True:
                rec = self.server.poll_log(vid)
                if rec is None:
                    break
                arr = arrays.get(rec["block_id"])
                if arr is not None and len(rec["payload"]) >= 12:
                    arr[b] = struct.unpack("<fff", rec["payload"][:12])
                    if rec["block_id"] == 1:
                        self.last_update[b] = tick

    def staleness(self, tick: int) -> np.ndarray:
        return tick - np.where(self.last_update < 0, tick,
                               self.last_update)


def serve_swarm(spec: OCPSpec, server, vids, fws, swarm: SwarmNMPC,
                ticks: int, rate_hz: float = 66.6,
                lockstep: bool = True,
                wire_settle_s: float = 0.5) -> SwarmReport:
    """Fly B wire vehicles from ONE batched device solve for `ticks`.

    server/vids/fws: a LinkServer with the B registered vehicles and
    their `CascadeFirmwareSim` endpoints (same order as swarm.targets).

    lockstep=True advances each vehicle's physics exactly one period per
    host tick via manual poll() — deterministic (the wire is still real
    UDP both ways).  Each tick WAITS until every vehicle's current-tick
    telemetry has crossed the link (`wire_settle_s` bounds that wait —
    generous, because lockstep correctness must not depend on host
    speed: with a tight bound a contended host consumes stale rows and
    the estimator's velocity differentiation destabilizes on the
    position jumps).  The typical settle is well under a millisecond.
    lockstep=False expects the endpoints to be serving real time and
    paces the host loop with a TickScheduler.
    """
    from crazyflie_nmpc_tpu.runtime.serving import TickScheduler

    period = 1.0 / rate_hz
    period_ms = max(1, int(round(period * 1e3)))
    B = len(vids)
    plane = _TelemetryPlane(server, vids, fws)

    swarm.reset(np.stack([fw.x for fw in fws]))
    # compile the batched step OUTSIDE the accounted loop (same shapes/
    # dtypes as the serving ticks), then restore a fresh carry
    swarm.step(plane.mocap, plane.euler, plane.gyro)
    swarm.reset(np.stack([fw.x for fw in fws]))

    latency = np.zeros((ticks, B))
    staleness = np.zeros((ticks, B), np.int64)
    positions = np.zeros((ticks, B, 3))
    sched = None
    if not lockstep:
        sched = TickScheduler(period)
        sched.start()

    for k in range(ticks):
        if lockstep:
            # advance every vehicle one tick period (physics + stream),
            # then wait until THIS tick's rows have crossed the link
            for fw in fws:
                fw.poll(period_ms)
            deadline = time.perf_counter() + wire_settle_s
            while True:
                plane.drain(k)
                if (plane.last_update >= k).all():
                    break
                if time.perf_counter() >= deadline:
                    break
                time.sleep(0.0002)    # yield to the link threads
        else:
            sched.wait_for_tick(k)

        t_state = time.perf_counter()
        plane.drain(k)
        staleness[k] = plane.staleness(k)
        positions[k] = plane.mocap
        cmd, _u_apply = swarm.step(plane.mocap, plane.euler, plane.gyro)
        for b, vid in enumerate(vids):
            server.send_setpoint(vid, float(cmd[b, 0]), float(cmd[b, 1]),
                                 float(cmd[b, 2]), int(cmd[b, 3]))
            latency[k, b] = time.perf_counter() - t_state

    # settle the wire so the last setpoints land before teardown
    # (lockstep only: in realtime mode the serve threads are pumping and
    # a concurrent manual poll would race them on the socket)
    if lockstep:
        for fw in fws:
            fw.poll(1)
    else:
        time.sleep(0.02)
    final_err = np.linalg.norm(
        np.stack([fw.x[:3] for fw in fws]) - swarm.targets, axis=1)
    return SwarmReport(
        n_vehicles=B, ticks=ticks, period_s=period,
        latency_s=latency, staleness=staleness,
        final_err_m=final_err, positions=positions,
        schedule_slips=sched.slips if sched else 0)


def grid_targets(n: int, spacing: float = 0.6, z: float = 0.4):
    """A square-ish formation grid at height z, centered on the origin."""
    cols = int(np.ceil(np.sqrt(n)))
    pts = []
    for i in range(n):
        r, c = divmod(i, cols)
        pts.append((c * spacing, r * spacing, z))
    pts = np.asarray(pts, np.float64)
    pts[:, :2] -= pts[:, :2].mean(axis=0)
    return pts
