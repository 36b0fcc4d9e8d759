"""Benchmark: NMPC solves/s on one GPU at the reference problem size (N=50).

Prints ONE JSON line:
  {"metric": "nmpc_solves_per_s_n50", "value": ..., "unit": "solves/s",
   "device": {...}, "b_sweep": {...}, "certified_solves_per_s": {...},
   "latency": {...}, "serving": {...}, "swarm": {...}}

Each "solve" is a full SQP-RTI iteration on the 13-state/4-input Crazyflie
OCP with N=50 shooting intervals: ERK4 linearization with forward
sensitivities at all 50 stages, Gauss-Newton QP assembly, and an 8-iteration
Mehrotra interior-point solve (Riccati-factorized), i.e. the same work the
reference's acados_solve() does per control tick (acados_mpc.cpp:611).
Every time is host wall clock around chained steps that end in
`block_until_ready`.  Diagnostics go to stderr.

The benchmark needs a GPU: without one it exits with an error and prints
no result.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    """`nvidia-smi` name and power limit of the card ("" if unavailable)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def measure_chained(step, states0, x0s, steps=20, rounds=5):
    """Median per-step wall time over `rounds` chains of `steps` steps,
    each chain ending in block_until_ready."""
    s, u0 = step(states0, x0s)
    jax.block_until_ready(u0)                    # warm
    ds = []
    for _ in range(rounds):
        s = states0
        t0 = time.perf_counter()
        for _ in range(steps):
            s, u0 = step(s, x0s)
        jax.block_until_ready((s, u0))
        ds.append((time.perf_counter() - t0) / steps)
    ds.sort()
    return ds[len(ds) // 2]


def main():
    from crazyflie_nmpc_tpu.ops.backend import sweep_backend
    from crazyflie_nmpc_tpu.utils.cache import setup_compilation_cache

    dev = jax.devices()[0]
    if sweep_backend(dev.platform) != "kernel":
        log(f"bench.py needs a GPU; the default device is {dev} "
            f"({dev.platform})")
        sys.exit(2)
    setup_compilation_cache()

    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.ops import ipm
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import (
        rti_step_batched,
        to_batch_last,
    )

    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()),
                  name_power_limit=card_name_and_power_limit())
    log(f"device: {device}")

    spec = default_ocp(N=50, dtype=jnp.float32)
    cfg = ipm.IPMConfig(iters=8)
    yref, yref_e = hover_yref(spec)

    def make_batch(B, x_offset=0.0, seed=0):
        key = jax.random.PRNGKey(seed)
        x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
               + 0.05 * jax.random.normal(key, (B, 13), jnp.float32))
        x0s = x0s.at[:, 0].add(x_offset)
        states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
        # the serving loop carries batch-last state: chained steps then
        # skip two layout transposes per tick
        return to_batch_last(states), x0s

    def make_step(ipm_cfg=None):
        @jax.jit
        def step(states, x0s):
            new_states, outs = rti_step_batched(
                spec, states, x0s, yref, yref_e, ipm_cfg or cfg,
                layout="batch_last")
            return new_states, outs.u0
        return step

    best = 0.0
    b_sweep = {}
    step = make_step()
    for B in (1024, 2048, 4096, 8192):
        states, x0s = make_batch(B)
        t0 = time.perf_counter()
        jax.block_until_ready(step(states, x0s))
        log(f"B={B}: compile+first {time.perf_counter() - t0:.2f}s")
        dt = measure_chained(step, states, x0s)
        rate = B / dt
        log(f"B={B}: {dt * 1e3:.3f} ms/step -> {rate:,.0f} solves/s")
        b_sweep[str(B)] = rate
        best = max(best, rate)

    # CERTIFIED operating points: iters=8 + per-lane escalation to 16 / 32
    # (tests/test_certification.py, tools/bangbang_cert.py).
    # escalate_mu_tol=0 forces the escalation sub-solve (capacity=256
    # lanes) on EVERY step: the worst-case per-step cost on a batch that
    # saturates the input bound (0.3 m offsets).
    certified = {}
    states_c, x0c = make_batch(4096, x_offset=0.3, seed=1)
    for esc in (16, 32):
        cfg_c = ipm.IPMConfig(iters=8, escalate_iters=esc,
                              escalate_capacity=256, escalate_mu_tol=0.0)
        dt = measure_chained(make_step(cfg_c), states_c, x0c)
        certified[f"esc{esc}"] = 4096 / dt
        log(f"certified (8 + escalate{esc}, worst case, saturating "
            f"batch): {dt * 1e3:.3f} ms/step -> {4096 / dt:,.0f} solves/s")

    # feedback latency at small batch (reference real-time budget 15 ms)
    B_lat = 128
    step_l = make_step(ipm.IPMConfig(iters=5))
    states, x0s = make_batch(B_lat)
    jax.block_until_ready(step_l(states, x0s))
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        jax.block_until_ready(step_l(states, x0s))
        lat.append(time.perf_counter() - t0)
    lat.sort()
    dt_dev = measure_chained(step_l, states, x0s, steps=30)
    latency = dict(batch=B_lat, chained_ms=dt_dev * 1e3,
                   synced_p50_ms=lat[25] * 1e3, synced_max_ms=lat[-1] * 1e3)
    log(f"RTI feedback latency (B={B_lat}): {latency}")

    serving = serving_run(spec, yref, yref_e)
    swarm = swarm_over_wire()

    print(json.dumps({
        "metric": "nmpc_solves_per_s_n50",
        "value": best,
        "unit": "solves/s",
        "device": device,
        "b_sweep": b_sweep,
        "certified_solves_per_s": certified,
        "latency": latency,
        "serving": serving,
        "swarm": swarm,
    }))


def swarm_over_wire(n: int = 16, ticks: int = 200, base_port: int = 48200):
    """n cascade-plant vehicles behind the native link server, ONE
    batched `rti_step_batched` launch per tick on the device, telemetry
    returning into the batched estimator (lockstep: each tick advances
    every vehicle one 15 ms period; emit latency is wall clock)."""
    import contextlib

    from crazyflie_nmpc_tpu import native
    from crazyflie_nmpc_tpu.runtime.swarm import (
        SwarmNMPC,
        grid_targets,
        serve_swarm,
    )
    from crazyflie_nmpc_tpu.solver import default_ocp

    spec = default_ocp(dtype=jnp.float32)
    targets = grid_targets(n, spacing=0.6, z=0.4)
    swarm = SwarmNMPC(spec, targets, use_fused=True)
    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(native.CascadeFirmwareSim(
            base_port + 2 * i,
            x0=(float(targets[i, 0]), float(targets[i, 1]), 0.03)))
            for i in range(n)]
        server = stack.enter_context(native.LinkServer())
        vids = list(range(1, n + 1))
        for i, vid in enumerate(vids):
            server.add_vehicle(vid, "127.0.0.1", base_port + 2 * i,
                               base_port + 2 * i + 1)
        rep = serve_swarm(spec, server, vids, fws, swarm, ticks)
    s = rep.summary()
    out = dict(n_vehicles=n, ticks=ticks, p50_ms=s["p50_ms"],
               p99_ms=s["p99_ms"],
               worst_vehicle_miss=s["worst_vehicle_miss"],
               stale_ticks=s["stale_ticks"],
               final_err_max_m=s["final_err_max_m"])
    log(f"[swarm] {out}")
    return out


def serving_run(spec, yref, yref_e, seconds: float = 10.0):
    """`runtime.serving.ServingLoop` at the reference's 66.6 Hz
    (acados_estimator.cpp:642), batch 1, against a host-side simulated
    plant on the CPU backend, plus the transport floor (state in,
    command out, no solve)."""
    import numpy as np

    from crazyflie_nmpc_tpu.models import dynamics, hover_state
    from crazyflie_nmpc_tpu.ops import ipm
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu.runtime.serving import (
        ServeConfig,
        ServingLoop,
        measure_transport_floor,
    )
    from crazyflie_nmpc_tpu.utils.cache import persistent_cache_disabled

    cpu = jax.local_devices(backend="cpu")[0]
    dt = float(spec.dt)
    setpoint = (0.0, 0.0, 0.5)
    x0 = hover_state(spec.params, pos=(0.2, -0.15, 0.3), dtype=jnp.float32)
    plant = {"x": jax.device_put(x0[None], cpu)}
    pstep = jax.jit(jax.vmap(
        lambda x, u: rk4_step(dynamics, spec.params, x, u, dt)))
    # CPU-pinned compile stays out of the persistent cache (utils/cache.py)
    with persistent_cache_disabled():
        pstep(plant["x"], jax.device_put(jnp.zeros((1, 4), jnp.float32),
                                         cpu))

    def source(k):
        return np.asarray(plant["x"])

    def sink(k, cmd, u_apply):
        u = jnp.asarray(u_apply, jnp.float32).reshape(1, 4)
        plant["x"] = pstep(plant["x"], jax.device_put(u, cpu))

    floor = measure_transport_floor(batch=1, n=100)
    loop = ServingLoop(spec, ipm.IPMConfig(iters=8),
                       ServeConfig(rate_hz=66.6, pipeline_depth=0), batch=1)
    loop.warmup(source(0), yref, yref_e)
    loop.reset(source(0))
    rep = loop.run(int(seconds * 66.6), source, sink, yref, yref_e)
    s = rep.summary()
    err = float(np.abs(np.asarray(plant["x"])[0, 0:3]
                       - np.asarray(setpoint)).max())
    out = dict(rate_hz=66.6, ticks=s["ticks"], p50_ms=s["p50_ms"],
               p99_ms=s["p99_ms"], deadline_misses=s["deadline_misses"],
               schedule_slips=s["schedule_slips"], final_pos_err_m=err,
               transport_floor_p50_ms=floor["p50_ms"],
               transport_floor_p99_ms=floor["p99_ms"])
    log(f"[serving] {out}")
    return out


if __name__ == "__main__":
    main()
