"""Real-time serving measurement: the 66.6 Hz host-in-the-loop story.

Runs the serving mode (`runtime.serving.ServingLoop`) against a
host-side simulated plant at the reference's loop rate
(acados_estimator.cpp:642) with per-tick deadline accounting, and prints
the decomposition:

  1. transport floor — the minimal state-in/command-out round trip through
     whatever connects this host to the accelerator (solver excluded);
  2. synchronous serving — host-observed feedback latency per tick
     (state crosses host boundary -> cmd_vel emitted);
  3. pipelined serving — sustained 66.6 Hz with depth-d in-flight solves
     and device-side gap prediction (see runtime/serving.py), for hosts
     whose transport exceeds the tick period;
  4. swarm tick — one 256-drone batched serving tick (BASELINE config 4).

On a host with a PCIe-attached card the transport floor is tens of
microseconds and synchronous serving ~= device-resident solve time.

Run:  python examples/serving_rt.py [--seconds 60] [--swarm 256] [--cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import jax


def run_serving(tag, loop, source, sink, yref, yref_e, n_ticks):
    rep = loop.run(n_ticks, source, sink, yref, yref_e)
    s = rep.summary()
    print(f"[{tag}] ticks={s['ticks']} rate={s['rate_hz']:.1f} Hz "
          f"depth={s['pipeline_depth']}")
    print(f"  feedback latency p50={s['p50_ms']:.3f} ms "
          f"p99={s['p99_ms']:.3f} ms max={s['max_ms']:.3f} ms")
    print(f"  deadline misses (budget {s['budget_ms']:.1f} ms"
          f"{' + depth' if s['pipeline_depth'] else ''}): "
          f"{s['deadline_misses']}   schedule slips: {s['schedule_slips']}")
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--swarm", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from crazyflie_nmpc_tpu.models import dynamics, hover_state
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.runtime.serving import (
        ServeConfig, ServingLoop, measure_transport_floor)
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref

    platform = jax.devices()[0].platform
    print(f"device: {jax.devices()[0].device_kind} ({platform})")
    spec = default_ocp(dtype=jnp.float32)
    n_ticks = int(args.seconds * 66.6)
    setpoint = (0.0, 0.0, 0.5)
    yref, yref_e = hover_yref(spec, pos=setpoint)
    dt = float(spec.dt)

    # 1 — transport floor
    floor = measure_transport_floor(batch=1)
    print(f"[transport floor] {floor['platform']}: "
          f"p50={floor['p50_ms']:.3f} ms p99={floor['p99_ms']:.3f} ms "
          f"(state in + command out, no solver)")

    # the simulated plant is HOST-side state (it stands in for the real
    # world at the host boundary) — pin it to the CPU backend so plant
    # stepping never rides the accelerator transport being measured
    cpu = jax.local_devices(backend="cpu")[0]

    def make_plant(batch):
        x0 = hover_state(spec.params, pos=(0.2, -0.15, 0.3),
                         dtype=jnp.float32)
        xb = jax.device_put(jnp.broadcast_to(x0, (batch,) + x0.shape), cpu)
        plant = {"x": xb}
        pstep = jax.jit(jax.vmap(
            lambda x, u: rk4_step(dynamics, spec.params, x, u, dt)))
        pstep(plant["x"],
              jax.device_put(jnp.zeros((batch, 4), jnp.float32), cpu))

        def source(k):
            return np.asarray(plant["x"])

        def sink(k, cmd, u_apply):
            plant["x"] = pstep(plant["x"],
                               jax.device_put(u_apply, cpu))

        return plant, source, sink

    # 1b — device-resident solve latency (the on-host serving component):
    # chained steps in flight, timed in chunks of 10 so the distribution
    # is over chunk means — per-step host sync would re-measure the
    # transport, which is exactly what this number excludes.
    from crazyflie_nmpc_tpu.solver.rti import init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched
    from crazyflie_nmpc_tpu.solver.rti import RTIState

    x0h = hover_state(spec.params, pos=(0.2, -0.15, 0.3), dtype=jnp.float32)
    x0b = jnp.broadcast_to(x0h, (128,) + x0h.shape)
    st = jax.vmap(lambda x: init_rti(spec, x))(x0b)
    st = RTIState(x_traj=jnp.moveaxis(st.x_traj, 0, -1),
                  u_traj=jnp.moveaxis(st.u_traj, 0, -1))
    dev_step = jax.jit(lambda s, x: rti_step_batched(
        spec, s, x, yref, yref_e, IPMConfig(iters=8), layout="batch_last"))
    st, out = dev_step(st, x0b)
    jax.block_until_ready(out.u0)
    chunk, chunks = 10, 30
    means = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(chunk):
            st, out = dev_step(st, x0b)
        jax.block_until_ready(out.u0)
        means.append((time.perf_counter() - t0) / chunk)
    means_ms = 1e3 * np.asarray(means)
    print(f"[device-resident solve, B=128 lanes] per-step over "
          f"{chunks} x {chunk}-step chunks: p50={np.percentile(means_ms, 50):.3f} ms "
          f"p99={np.percentile(means_ms, 99):.3f} ms (target < 10 ms)")

    # 2 — synchronous serving, B=1
    loop = ServingLoop(spec, IPMConfig(iters=8),
                       ServeConfig(pipeline_depth=0), batch=1)
    plant, source, sink = make_plant(1)
    loop.warmup(source(0), yref, yref_e)
    loop.reset(source(0))
    rep_sync = run_serving("sync B=1", loop, source, sink, yref, yref_e,
                           n_ticks)
    on_host = max(rep_sync.percentile(50) * 1e3 - floor["p50_ms"], 0.0)
    print(f"  on-host serving estimate (p50 - transport floor): "
          f"{on_host:.3f} ms")
    err = np.abs(np.asarray(plant["x"])[0, 0:3] - np.asarray(setpoint))
    print(f"  closed-loop position error after run: {err.max():.4f} m")

    # 3 — pipelined serving, B=1
    loop_p = ServingLoop(spec, IPMConfig(iters=8),
                         ServeConfig(pipeline_depth=args.depth), batch=1)
    plant, source, sink = make_plant(1)
    loop_p.warmup(source(0), yref, yref_e)
    loop_p.reset(source(0))
    rep_pipe = run_serving(f"pipelined d={args.depth} B=1", loop_p, source,
                           sink, yref, yref_e, n_ticks)
    err = np.abs(np.asarray(plant["x"])[0, 0:3] - np.asarray(setpoint))
    print(f"  closed-loop position error after run: {err.max():.4f} m")

    # 4 — swarm tick (BASELINE config 4): one batched serving tick for a
    # whole fleet, synchronous discipline
    B = args.swarm
    loop_s = ServingLoop(spec, IPMConfig(iters=8),
                         ServeConfig(pipeline_depth=0), batch=B)
    plant, source, sink = make_plant(B)
    loop_s.warmup(source(0), yref, yref_e)
    loop_s.reset(source(0))
    n_swarm = min(n_ticks, int(20 * 66.6))
    rep_swarm = run_serving(f"sync swarm B={B}", loop_s, source, sink,
                            yref, yref_e, n_swarm)
    on_host_sw = max(rep_swarm.percentile(50) * 1e3 - floor["p50_ms"], 0.0)
    print(f"  on-host swarm tick estimate (p50 - transport floor): "
          f"{on_host_sw:.3f} ms (budget 15 ms)")

    # 5 — schedule integrity at a rate this transport can sustain: the
    # loop must hold an absolute schedule with zero misses/slips when the
    # platform's round trip fits the period (66.6 Hz on a PCIe-attached
    # card; a slower transport derates it to prove the serving machinery
    # rather than the transport).
    sustain_hz = min(66.6, 1.0 / (1.3 * (floor["p99_ms"] * 1e-3 + 0.010)))
    loop_i = ServingLoop(spec, IPMConfig(iters=8),
                         ServeConfig(rate_hz=sustain_hz, pipeline_depth=0),
                         batch=1)
    plant, source, sink = make_plant(1)
    loop_i.warmup(source(0), yref, yref_e)
    loop_i.reset(source(0))
    run_serving(f"sustained @{sustain_hz:.1f} Hz B=1", loop_i, source, sink,
                yref, yref_e, int(args.seconds * sustain_hz))


if __name__ == "__main__":
    main()
