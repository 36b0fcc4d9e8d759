"""Real-time NMPC serving: fixed-rate host loop with deadline accounting.

The reference's defining runtime property is a hard-rate feedback loop: a
66.6 Hz ros::Timer drives estimator + NMPC (acados_estimator.cpp:642),
giving each tick a 15 ms budget, with the solve itself targeted well under
10 ms; round-trip actuation delay is absorbed by commanding deeper stages
of the open-loop plan (u1 / x4 = +60 ms, acados_mpc.cpp:619-670).

This module is the accelerator serving mode.  State crosses the host
boundary as arrays, a latency-compiled solve runs on the device, and the
cmd_vel command leaves — all under an absolute-time tick schedule with
per-tick accounting (feedback latency, deadline misses, schedule slips).

Two serving disciplines, both first-class:

  * synchronous (pipeline_depth=0): the command for tick k is computed and
    emitted inside tick k.  Feedback latency = solve + host<->device
    transport; this is the reference's own discipline.
  * pipelined (pipeline_depth=d>0): the solve for tick k is dispatched
    asynchronously and its command emitted d ticks later, while newer
    solves are already in flight.  The d ticks of actuation delay are
    compensated the way the reference compensates its radio round-trip —
    by predicting the anchor state forward through the gap (the acados
    sim-solver predictor, acados_estimator.cpp:573-593) — but with one
    improvement the pipeline makes possible: the commands that WILL act
    during the gap are exactly the d in-flight solves' outputs, already
    device-resident, so the predictor integrates under the *actual*
    pending command buffer instead of the reference's single last
    command.  (Plain stage-shifted extraction without prediction is NOT
    stable on the rotor-level plant — the anchor staleness compounds
    through the open-loop-unstable attitude dynamics; pinned in
    tests/test_serving.py.)  This hides host<->device transport latency
    that exceeds the tick period (remote accelerators) while keeping the
    loop rate and closed-loop semantics intact.

The scheduler/accounting core (`TickScheduler`) is pure host logic with an
injectable clock, unit-tested with a fake clock; `ServingLoop` binds it to
the compiled solver path.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from crazyflie_nmpc_tpu.ops.backend import sweep_backend
from crazyflie_nmpc_tpu.ops.integrators import integrate
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.outputs import to_cmd_vel
from crazyflie_nmpc_tpu.solver.rti import RTIState, init_rti, rti_step
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-rate contract (reference values: acados_estimator.cpp:642)."""

    rate_hz: float = 66.6
    #: per-tick deadline for the emitted command; None = one period (15 ms)
    budget_s: Optional[float] = None
    #: headline latency target (BASELINE.json: feedback < 10 ms)
    target_s: float = 0.010
    #: 0 = synchronous; d>0 = d solves in flight, commands d stages deeper
    pipeline_depth: int = 0

    @property
    def period_s(self) -> float:
        return 1.0 / self.rate_hz

    @property
    def budget(self) -> float:
        return self.period_s if self.budget_s is None else self.budget_s


@dataclasses.dataclass
class ServeReport:
    """Per-run accounting produced by the serving loop."""

    config: ServeConfig
    #: feedback latency per emitted command: emit instant - the instant the
    #: corresponding state crossed the host boundary (seconds)
    latency_s: np.ndarray
    #: service time per tick: emit instant - scheduled tick start
    service_s: np.ndarray
    #: scheduled tick starts that slipped by more than half a period
    schedule_slips: int
    ticks: int

    def percentile(self, q: float, which: str = "latency") -> float:
        arr = self.latency_s if which == "latency" else self.service_s
        return float(np.percentile(arr, q)) if arr.size else float("nan")

    @property
    def deadline_misses(self) -> int:
        """Commands emitted past their deadline.

        Synchronous: latency > budget.  Pipelined (depth d): the command
        for tick k is scheduled to leave within tick k+d, so its deadline
        is (d periods + budget) after its state instant — the pipeline's
        advertised (and plan-compensated) latency.
        """
        d = self.config.pipeline_depth
        deadline = self.config.budget + d * self.config.period_s
        return int(np.sum(self.latency_s > deadline))

    def summary(self) -> dict:
        lat = self.latency_s
        return dict(
            ticks=self.ticks,
            rate_hz=self.config.rate_hz,
            pipeline_depth=self.config.pipeline_depth,
            p50_ms=1e3 * self.percentile(50),
            p99_ms=1e3 * self.percentile(99),
            max_ms=1e3 * float(lat.max()) if lat.size else float("nan"),
            deadline_misses=self.deadline_misses,
            schedule_slips=self.schedule_slips,
            budget_ms=1e3 * self.config.budget,
            target_ms=1e3 * self.config.target_s,
        )


class TickScheduler:
    """Absolute-time tick schedule with slip accounting.

    Ticks are anchored to t0 + k*period (never to the previous tick's end),
    so a slow tick does not shift the whole schedule — the same discipline
    as a ros::Timer.  `clock`/`sleep` are injectable for tests.
    """

    def __init__(self, period_s: float,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.period = period_s
        self.clock = clock
        self._sleep = sleep
        self.t0 = None
        self.slips = 0

    def start(self):
        self.t0 = self.clock()
        self.slips = 0
        return self.t0

    def tick_start(self, k: int) -> float:
        """Scheduled start instant of tick k."""
        return self.t0 + k * self.period

    def wait_for_tick(self, k: int) -> float:
        """Sleep until tick k's scheduled start; count slips > period/2.

        Returns the actual start instant.
        """
        target = self.tick_start(k)
        while True:
            now = self.clock()
            remaining = target - now
            if remaining <= 0:
                break
            # coarse sleep, then spin the last millisecond for precision
            if remaining > 1.5e-3:
                self._sleep(remaining - 1e-3)
            else:
                self._sleep(0)
        now = self.clock()
        if now - target > 0.5 * self.period:
            self.slips += 1
        return now


class ServingLoop:
    """Host-in-the-loop NMPC serving at a fixed rate.

    Binds the latency-compiled solver path to a `TickScheduler`:

        state_source(k) -> (B, nx) array      [the host boundary, in]
        ... device solve (+ plan-depth command extraction, on device) ...
        command_sink(k, cmd, u_apply)          [the host boundary, out]

    cmd is a BodyTwist of (B,) numpy arrays (the reference's cmd_vel
    contract, acados_mpc.cpp:644-670); u_apply is the (B, nu) rotor-speed
    command aligned to the emission instant (u_plan[depth] — the
    acados_motvel loopback, acados_mpc.cpp:628-642).

    The whole command extraction runs inside jit, so only (B,)-sized
    command vectors cross the device boundary per tick — never the plans.
    """

    def __init__(self, spec: OCPSpec,
                 ipm_config: Optional[IPMConfig] = None,
                 serve: ServeConfig = ServeConfig(), batch: int = 1,
                 use_fused: Optional[bool] = None,
                 predict_gap: bool = True):
        """predict_gap=False disables the pipeline-gap anchor prediction
        (solves run from the raw, depth-stale state) — the ablation arm
        of the delay-compensation claim: at depth > 0 on the rotor-level
        plant the un-predicted loop diverges while the default converges
        (pinned in tests/test_serving.py).  No effect at depth 0."""
        self.spec = spec
        self.serve = serve
        self.batch = batch
        self.predict_gap = predict_gap
        d = serve.pipeline_depth if predict_gap else 0
        if spec.N < 5:
            raise ValueError("the reference command extraction (u1, x4 = "
                             "+60 ms, acados_mpc.cpp:619-625) needs N >= 5")
        if use_fused is None:
            # the batched path (rti_step_batched) wherever its sweep
            # kernel runs; the vmapped single-problem path elsewhere
            use_fused = sweep_backend() == "kernel"
        self.use_fused = use_fused
        if ipm_config is None:
            # deliberate default = the CERTIFIED operating point
            # (ipm.certified_config): mu-gated escalation is cond-skipped
            # on the batched path when every lane converged, so
            # hover-class serving pays nothing (worst-case cost: bench.py
            # "certified").  On the vmapped
            # path the cond lowers to a select and both branches
            # pay every tick — pass an explicit IPMConfig there if
            # latency outweighs certified accuracy.
            ipm_config = certified_config(
                capacity=min(batch, 256) if use_fused else 0)
        self.ipm_config = ipm_config
        ode, params, dt, ss = spec.ode(), spec.params, spec.dt, spec.sim_steps

        def _predict(x0s, pending):
            """Advance (B, nx) anchors through the pipeline gap under the
            d pending (already-dispatched, not-yet-acting) commands."""
            for i in range(d):
                u_i = pending[i]
                x0s = jax.vmap(
                    lambda x, u: integrate(ode, params, x, u, dt, ss)
                )(x0s, u_i)
            return x0s

        if use_fused:
            kw = dict(config=ipm_config, layout="batch_last")

            def _step(carry, x0s, yref, yref_e):
                states, pending = carry
                x0s = _predict(x0s, pending)
                states, out = rti_step_batched(spec, states, x0s,
                                               yref, yref_e, **kw)
                u_apply = out.u_plan[0].T                     # (B, nu)
                if d:
                    pending = jnp.concatenate(
                        [pending[1:], u_apply[None]], axis=0)
                cmd = to_cmd_vel(out.u_plan[1].T, out.x_plan[4].T)
                return (states, pending), cmd, u_apply, out.kkt_res
        else:
            vstep = jax.vmap(
                lambda s, x, yr, ye: rti_step(spec, s, x, yr, ye,
                                              ipm_config),
                in_axes=(0, 0, None, None))

            def _step(carry, x0s, yref, yref_e):
                states, pending = carry
                x0s = _predict(x0s, pending)
                states, out = vstep(states, x0s, yref, yref_e)
                u_apply = out.u_plan[:, 0]
                if d:
                    pending = jnp.concatenate(
                        [pending[1:], u_apply[None]], axis=0)
                cmd = to_cmd_vel(out.u_plan[:, 1], out.x_plan[:, 4])
                return (states, pending), cmd, u_apply, out.kkt_res

        self._step = jax.jit(_step, donate_argnums=(0,))
        self._carry = None

    # -- state management -------------------------------------------------
    def reset(self, x0s: np.ndarray):
        """(Re)initialize warm starts + pending-command buffer from (B, nx)
        states.  Pending commands start at the steady input (hover) — the
        same neutral assumption the estimator predictor makes before the
        first command arrives."""
        x0s = np.asarray(x0s)
        if self.use_fused:
            st = jax.vmap(lambda x: init_rti(self.spec, x))(jnp.asarray(x0s))
            states = RTIState(x_traj=jnp.moveaxis(st.x_traj, 0, -1),
                              u_traj=jnp.moveaxis(st.u_traj, 0, -1))
        else:
            states = jax.vmap(lambda x: init_rti(self.spec, x))(
                jnp.asarray(x0s))
        d = self.serve.pipeline_depth
        uss = self.spec.steady_input(states.u_traj.dtype)
        pending = jnp.broadcast_to(uss, (d, x0s.shape[0]) + uss.shape)
        self._carry = (states, pending)

    def _emit(self, handle):
        """Fetch a dispatched step's command tensors to host numpy."""
        cmd, u_apply, kkt = handle
        cmd, u_apply = jax.device_get((cmd, u_apply))
        cmd = type(cmd)(*[np.asarray(f) for f in cmd])
        return cmd, np.asarray(u_apply)

    def warmup(self, x0s: np.ndarray, yref, yref_e, iters: int = 3):
        """Compile + run a few steps so `run` starts hot."""
        self.reset(x0s)
        for _ in range(iters):
            self._carry, cmd, u_apply, kkt = self._step(
                self._carry, jnp.asarray(x0s), yref, yref_e)
        jax.block_until_ready(cmd)

    # -- the serving loop ---------------------------------------------------
    def run(self, n_ticks: int, state_source, command_sink, yref, yref_e,
            clock: Callable[[], float] = time.perf_counter,
            sleep: Callable[[float], None] = time.sleep) -> ServeReport:
        """Serve `n_ticks` ticks at the configured rate.

        state_source(k) -> (B, nx) numpy state at the host boundary.
        command_sink(k, cmd, u_apply): receives tick k's command (for
        pipelined serving this is called d ticks after k, with the
        stage-shifted plan rows — see the module docstring).
        """
        if self._carry is None:
            raise RuntimeError("call warmup()/reset() before run()")
        depth = self.serve.pipeline_depth
        sched = TickScheduler(self.serve.period_s, clock, sleep)
        inflight = collections.deque()   # (tick, state_instant, handle)
        latency, service = [], []

        sched.start()
        total = n_ticks + depth
        for k in range(total):
            sched.wait_for_tick(k)
            if k < n_ticks:
                t_state = clock()
                x0s = np.asarray(state_source(k))
                dev = jnp.asarray(x0s)
                self._carry, cmd, u_apply, kkt = self._step(
                    self._carry, dev, yref, yref_e)
                inflight.append((k, t_state, (cmd, u_apply, kkt)))
            if len(inflight) > depth or k >= n_ticks:
                tick, t_state, handle = inflight.popleft()
                cmd, u_apply = self._emit(handle)   # blocks until ready
                t_emit = clock()
                command_sink(tick, cmd, u_apply)
                latency.append(t_emit - t_state)
                service.append(t_emit - sched.tick_start(tick + depth))

        return ServeReport(
            config=self.serve,
            latency_s=np.asarray(latency),
            service_s=np.asarray(service),
            schedule_slips=sched.slips,
            ticks=n_ticks,
        )


def measure_transport_floor(nx: int = 13, batch: int = 1,
                            n: int = 200) -> dict:
    """Per-tick host<->device transport cost, solver excluded.

    Times the minimal serving round trip — put a (B, nx) state, run a
    trivial device op, fetch a (B, 4)-sized command — through whatever
    path connects this host to the accelerator (tens of microseconds on
    a PCIe-attached card).  Subtracting it from host-synced serving
    latency isolates the on-host serving cost.
    """
    dev = jax.devices()[0]
    f = jax.jit(lambda x: x[:, :4] + 1.0)
    x = np.zeros((batch, nx), np.float32)
    jax.block_until_ready(f(jax.device_put(x, dev)))   # compile
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = f(jax.device_put(x, dev))
        np.asarray(out)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return dict(platform=dev.platform,
                p50_ms=1e3 * float(np.percentile(ts, 50)),
                p99_ms=1e3 * float(np.percentile(ts, 99)))
