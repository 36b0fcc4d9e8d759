"""Smoke test of the batched NMPC solve on NVIDIA GPUs.

Drives the main path once through the entry points a user calls, at full
width: the N=50, 13-state, 4-input Crazyflie OCP in f32 over B=4096 lanes
(`solver.rti_batched.rti_step_batched`), the certified escalation config
on a saturating batch, the sweep kernel against the plain scan, the
real-time `ServingLoop`, the 16-vehicle swarm server over the native link,
and the N=400 horizon.  Each solve is compared with the plain reference,
the vmapped single-problem `solver.rti.rti_step` at f64 on the CPU, within
2e-3 kRPM on the 0-22 kRPM command scale.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the pod and stage-sharded paths

Earlier lines report what each phase found; the last line is one JSON
object.  Without a GPU, or when any phase fails, the script exits non-zero
and prints no result.  Everything runs in this one process.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

TOL = 2e-3        # kRPM: the compiled-parity bound of the batched path
B_MAIN = 4096
REF_LANES = 64


def log(*a):
    print(*a, flush=True)


def card_name_and_power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


class Phases:
    """Runs named checks, logs each verdict, and remembers failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            ok, msg = fn()
        except Exception as e:  # a phase that raises has failed
            traceback.print_exc()
            ok, msg = False, f"{type(e).__name__}: {e}"
        verdict = "ok" if ok else "FAILED"
        log(f"[{name}] {verdict} ({time.perf_counter() - t0:.1f} s): {msg}")
        if not ok:
            self.failed.append(name)


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def make_inputs(spec, B, seed, x_offset=0.0, noise=0.05):
    import jax
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import init_rti

    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + noise * jax.random.normal(jax.random.PRNGKey(seed), (B, 13),
                                       jnp.float32))
    x0s = x0s.at[:, 0].add(x_offset)
    return jax.vmap(lambda x: init_rti(spec, x))(x0s), x0s


def reference_f64(N, tf, states, x0s, cfg, lanes):
    """u_plan of the vmapped `rti_step` at f64 on the CPU, first `lanes`
    lanes of the same f32 inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, rti_step
    from crazyflie_nmpc_tpu.utils.cache import persistent_cache_disabled

    cpu = jax.local_devices(backend="cpu")[0]
    f64 = lambda a: jax.device_put(
        np.asarray(a[:lanes], np.float64), cpu)
    with jax.enable_x64(True), jax.default_device(cpu), \
            persistent_cache_disabled():
        spec = default_ocp(N=N, tf=tf, dtype=jnp.float64)
        yref, yref_e = hover_yref(spec)
        st = jax.tree.map(f64, states)
        _, out = jax.jit(jax.vmap(lambda s, x: rti_step(
            spec, s, x, yref, yref_e, cfg)))(st, f64(x0s))
        return np.asarray(out.u_plan)


def compile_step(spec, cfg, states, x0s, **kw):
    """The jitted batched step, compiled; logs compile time and memory."""
    import jax

    from crazyflie_nmpc_tpu.solver import hover_yref
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    yref, yref_e = hover_yref(spec)
    step = jax.jit(lambda s, x: rti_step_batched(spec, s, x, yref, yref_e,
                                                 cfg, **kw))
    t0 = time.perf_counter()
    compiled = step.lower(states, x0s).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    mem_s = ("n/a" if mem is None else
             f"args {mem.argument_size_in_bytes / 2**20:.1f} MiB, "
             f"out {mem.output_size_in_bytes / 2**20:.1f} MiB, "
             f"temp {mem.temp_size_in_bytes / 2**20:.1f} MiB")
    log(f"  compile {dt:.1f} s (N={spec.N}, B={x0s.shape[0]}, {kw}); "
        f"memory_analysis: {mem_s}")
    return compiled


def step_time_ms(compiled, states, x0s, steps=10, rounds=3):
    """Median per-step time of chained steps ending in block_until_ready."""
    import jax

    jax.block_until_ready(compiled(states, x0s))
    ds = []
    for _ in range(rounds):
        s = states
        t0 = time.perf_counter()
        for _ in range(steps):
            s, out = compiled(s, x0s)
        jax.block_until_ready((s, out))
        ds.append((time.perf_counter() - t0) / steps)
    return 1e3 * sorted(ds)[rounds // 2]


def check_against_f64(spec, cfg, states, x0s, out, lanes=REF_LANES):
    import numpy as np

    u = np.asarray(out.u_plan)
    finite = bool(np.all(np.isfinite(u))
                  and np.all(np.isfinite(np.asarray(out.x_plan))))
    ref = reference_f64(spec.N, float(spec.tf), states, x0s, cfg, lanes)
    du = float(np.abs(u[:lanes] - ref).max())
    return finite and du <= TOL, (f"every lane finite: {finite}; max|du| "
                                  f"vs f64 reference over {lanes} lanes = "
                                  f"{du:.3e} kRPM (bound {TOL:g})")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_main(spec, cfg, B=B_MAIN, seen=None):
    """The default entry point (the platform picks the sweeps); `seen`
    keeps its result for the kernel-vs-plain phase."""
    states, x0s = make_inputs(spec, B, seed=0)
    compiled = compile_step(spec, cfg, states, x0s)
    _, out = compiled(states, x0s)
    ok, msg = check_against_f64(spec, cfg, states, x0s, out)
    ms = step_time_ms(compiled, states, x0s)
    from crazyflie_nmpc_tpu.ops.backend import sweep_backend

    if seen is not None and sweep_backend() == "kernel":
        seen[B] = (out.u_plan, ms)
    return ok, f"sweeps: {sweep_backend()}; {msg}; {ms:.3f} ms/step"


def phase_certified(spec, B=B_MAIN):
    from crazyflie_nmpc_tpu.ops.ipm import certified_config

    # every lane may escalate, as every problem of the reference does
    cfg = certified_config(capacity=B)
    states, x0s = make_inputs(spec, B, seed=1, x_offset=0.3)
    compiled = compile_step(spec, cfg, states, x0s)
    _, out = compiled(states, x0s)
    ok, msg = check_against_f64(spec, cfg, states, x0s, out)
    return ok, f"saturating batch (x + 0.3 m), escalate 32: {msg}"


def phase_kernel_vs_plain(spec, cfg, B=B_MAIN, kernel="kernel", seen=None):
    """Same inputs as `phase_main`, whose result (the platform's choice,
    the kernel on a GPU) is reused from `seen` when present."""
    import numpy as np

    states, x0s = make_inputs(spec, B, seed=0)
    u, ms = {}, {}
    if seen and B in seen:
        u[kernel], ms[kernel] = np.asarray(seen[B][0]), seen[B][1]
    for sweep in (kernel, "plain"):
        if sweep in u:
            continue
        compiled = compile_step(spec, cfg, states, x0s, sweep=sweep)
        _, out = compiled(states, x0s)
        u[sweep] = np.asarray(out.u_plan)
        ms[sweep] = step_time_ms(compiled, states, x0s)
    du = float(np.abs(u[kernel] - u["plain"]).max())
    finite = bool(np.all(np.isfinite(u[kernel])))
    return finite and du <= TOL, (
        f"max|du| kernel vs plain scan = {du:.3e} kRPM over {B} lanes; "
        f"step {ms[kernel]:.3f} ms (kernel) vs {ms['plain']:.3f} ms "
        f"(plain)")


def phase_serving(spec, ticks=60, use_fused=None):
    """`ServingLoop` at batch 1 and 66.6 Hz against a simulated plant on
    the CPU, started 5 cm off the set-point."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from crazyflie_nmpc_tpu.models import dynamics, hover_state
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu.runtime.serving import ServeConfig, ServingLoop
    from crazyflie_nmpc_tpu.solver import hover_yref
    from crazyflie_nmpc_tpu.utils.cache import persistent_cache_disabled

    setpoint = np.array([0.0, 0.0, 0.5])
    yref, yref_e = hover_yref(spec, pos=tuple(setpoint))
    cpu = jax.local_devices(backend="cpu")[0]
    x0 = hover_state(spec.params, pos=(0.04, -0.03, 0.52),
                     dtype=jnp.float32)
    plant = {"x": jax.device_put(x0[None], cpu)}
    dt = float(spec.dt)
    pstep = jax.jit(jax.vmap(lambda x, u: rk4_step(
        dynamics, spec.params, x, u, dt)))
    with persistent_cache_disabled():
        pstep(plant["x"], jax.device_put(jnp.zeros((1, 4), jnp.float32),
                                         cpu))

    def source(k):
        return np.asarray(plant["x"])

    def sink(k, cmd, u_apply):
        u = jnp.asarray(u_apply, jnp.float32).reshape(1, 4)
        plant["x"] = pstep(plant["x"], jax.device_put(u, cpu))

    loop = ServingLoop(spec, serve=ServeConfig(rate_hz=66.6,
                                               pipeline_depth=0), batch=1,
                       use_fused=use_fused)
    loop.warmup(source(0), yref, yref_e)
    loop.reset(source(0))
    err0 = float(np.abs(source(0)[0, :3] - setpoint).max())
    rep = loop.run(ticks, source, sink, yref, yref_e)
    s = rep.summary()
    err = float(np.abs(source(0)[0, :3] - setpoint).max())
    ok = (loop.use_fused and s["ticks"] == ticks and np.isfinite(err)
          and err < 0.2 * err0)
    return ok, (f"batched path {loop.use_fused}, {s['ticks']} ticks, "
                f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, "
                f"{s['deadline_misses']} deadline misses; position error "
                f"{err0:.3f} m -> {err:.4f} m")


def phase_swarm(n=16, ticks=100, use_fused=None):
    """`bringup.swarm_serving`: n cascade-plant vehicles behind the native
    link, one batched solve per tick, taking off to a 0.4 m formation."""
    from crazyflie_nmpc_tpu import bringup

    from crazyflie_nmpc_tpu.ops.backend import sweep_backend

    batched = (sweep_backend() == "kernel" if use_fused is None
               else use_fused)
    res = bringup.swarm_serving(n=n, ticks=ticks, use_fused=use_fused)
    s = res["summary"]
    ok = batched and s["stale_ticks"] == 0 and s["final_err_max_m"] < 0.1
    return ok, (f"batched path {batched}, {n} vehicles, {ticks} ticks, "
                f"stale ticks "
                f"{s['stale_ticks']}, final position error max "
                f"{s['final_err_max_m']:.4f} m, p50 {s['p50_ms']:.2f} ms, "
                f"p99 {s['p99_ms']:.2f} ms")


def phase_long_horizon(cfg, B=64):
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.solver import default_ocp

    spec = default_ocp(N=400, tf=6.0, dtype=jnp.float32)
    # hover-class start: at 5 cm / 0.05 rad perturbations the f32 plan's
    # far tail drifts ~5e-2 kRPM from f64 on any f32 path (PERF.md)
    states, x0s = make_inputs(spec, B, seed=2, noise=0.005)
    compiled = compile_step(spec, cfg, states, x0s)
    _, out = compiled(states, x0s)
    ok, msg = check_against_f64(spec, cfg, states, x0s, out, lanes=8)
    return ok, f"N=400, B={B}: {msg}"


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def phase_pod(spec, cfg, devices, per_card=B_MAIN):
    import jax
    import numpy as np

    from crazyflie_nmpc_tpu.parallel import make_mesh
    from crazyflie_nmpc_tpu.parallel.pod import pod_rti_step
    from crazyflie_nmpc_tpu.solver import hover_yref

    n = len(devices)
    mesh = make_mesh(batch=n, stage=1, devices=devices)
    states, x0s = make_inputs(spec, n * per_card, seed=3)
    yref, yref_e = hover_yref(spec)
    step = pod_rti_step(spec, mesh, cfg)
    _, out = step(states, x0s, yref, yref_e)
    u_pod = np.asarray(out.u_plan)
    one = jax.device_put((states, x0s), devices[0])
    _, ref = compile_step(spec, cfg, *one)(*one)
    du = float(np.abs(u_pod - np.asarray(ref.u_plan)).max())
    finite = bool(np.all(np.isfinite(u_pod)))
    return finite and du <= TOL, (
        f"{n}x1 batch mesh, B={n}x{per_card}: max|du| vs one-card "
        f"rti_step_batched = {du:.3e} kRPM")


def phase_stage_sharded(spec, cfg, devices, B=64, block=5):
    import jax
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from crazyflie_nmpc_tpu.parallel import make_mesh, stage_sharded_rti_step
    from crazyflie_nmpc_tpu.parallel.mesh import BATCH_AXIS
    from crazyflie_nmpc_tpu.solver import hover_yref, rti_step

    mesh = make_mesh(batch=2, stage=2, devices=devices[:4])
    states, x0s = make_inputs(spec, B, seed=4)
    yref, yref_e = hover_yref(spec)
    fn = shard_map(
        jax.vmap(lambda s, x: stage_sharded_rti_step(
            spec, mesh, block, s, x, yref, yref_e, cfg)),
        mesh=mesh, in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)), check_vma=False)
    _, out = jax.jit(fn)(states, x0s)
    _, ref = jax.jit(jax.vmap(lambda s, x: rti_step(
        spec, s, x, yref, yref_e, cfg)))(states, x0s)
    du = float(np.abs(np.asarray(out.u_plan)
                      - np.asarray(ref.u_plan)).max())
    finite = bool(np.all(np.isfinite(np.asarray(out.u_plan))))
    return finite and du <= TOL, (
        f"(batch=2, stage=2) mesh, B={B}, block {block}: max|du| vs "
        f"solver.rti.rti_step = {du:.3e} kRPM")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the pod (4x1 batch mesh) and the "
                         "stage-sharded (2x2 mesh) paths on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devices}",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke.py needs {need} GPUs; JAX found {devices}",
              file=sys.stderr)
        return 2

    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.ops import ipm
    from crazyflie_nmpc_tpu.solver import default_ocp
    from crazyflie_nmpc_tpu.utils.cache import setup_compilation_cache

    log(f"card: {card_name_and_power_limit()}")
    log(f"devices: {devices}")
    log(f"compile cache: {setup_compilation_cache()}")
    spec = default_ocp(N=50, dtype=jnp.float32)
    cfg = ipm.IPMConfig(iters=8)
    phases = Phases()
    if args.four_cards:
        cards = devices[:4]
        phases.run("pod", lambda: phase_pod(spec, cfg, cards))
        phases.run("stage_sharded",
                   lambda: phase_stage_sharded(spec, cfg, cards))
    else:
        seen = {}
        phases.run("main", lambda: phase_main(spec, cfg, seen=seen))
        phases.run("certified", lambda: phase_certified(spec))
        phases.run("kernel_vs_plain",
                   lambda: phase_kernel_vs_plain(spec, cfg, seen=seen))
        phases.run("serving", lambda: phase_serving(spec))
        phases.run("swarm", phase_swarm)
        phases.run("long_horizon", lambda: phase_long_horizon(cfg))
    if phases.failed:
        print(f"failed phases: {phases.failed}", file=sys.stderr)
        return 1
    dev = devices[0]
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
