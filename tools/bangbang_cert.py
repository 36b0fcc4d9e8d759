"""Bang-bang-regime certification vs the exact active-set oracle.

An earlier study reported that on fully saturated ticks (1.5 m
setpoint jump; ~104/150 ticks with most inputs at a bound) ALL iteration
budgets disagree with a 30-iteration self-reference by the full control
range, and attributed it to "active-set flips, not solver accuracy" —
without adjudication.  This tool points the shared-nothing oracle
(tests/_reference_rti.py: dense-KKT active-set, exact minimizer of the
RTI subproblem) at exactly that regime and answers three questions per
solver config:

  1. per-tick u0 / full-plan error vs the exact QP minimizer,
  2. the QP OBJECTIVE gap (J_solver - J_oracle on the oracle's own dense
     QP) — if u differs but the objective gap is ~0, the subproblem is
     degenerate (multiple minimizers) and the "flip" defense is real;
     if the gap is positive, the solver is genuinely unconverged,
  3. whether per-lane escalation (IPMConfig.escalate_*) closes it.

Configs: default Mehrotra-8, 8+escalate16, 8+escalate32.

Run (CPU, f64): python tools/bangbang_cert.py [--steps 150 --jump 1.5]
Prints one row per config.
"""

import argparse
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import _reference_rti as oracle
from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.models.quadrotor import dynamics
from crazyflie_nmpc_tpu.ops.integrators import integrate
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver.rti import rti_step


def qp_objective(H, g, z):
    return 0.5 * z @ H @ z + g @ z


def study(cfg, label, steps, jump, spec, check_every=1):
    """Closed loop from a `jump`-metre offset; certify each solve."""
    dt = float(spec.tf) / spec.N
    x0 = hover_state(spec.params, dtype=jnp.float64).at[0].set(jump)
    yref, yref_e = hover_yref(spec)

    ctrl = jax.jit(lambda st, x: rti_step(spec, st, x, yref, yref_e, cfg))
    plant = jax.jit(lambda x, u: integrate(dynamics, spec.params, x, u,
                                           spec.dt, spec.sim_steps))

    state = init_rti(spec, x0)
    x = x0
    rows = []
    sat_ticks = 0
    checked = skipped = 0
    for t in range(steps):
        prev = state
        state, out = ctrl(state, x)
        u_plan = np.asarray(out.u_plan)
        sat = np.mean((u_plan <= 1e-6) | (u_plan >= 22.0 - 1e-6))
        if sat > 0.05:
            sat_ticks += 1
        if t % check_every == 0:
            xt = np.asarray(prev.x_traj, np.float64)
            ut = np.asarray(prev.u_traj, np.float64)
            H, g, E, d, lb, ub, nz = oracle.build_dense_qp(
                xt, ut, np.asarray(x, np.float64), np.asarray(yref),
                np.asarray(yref_e), dt)
            off = (spec.N + 1) * oracle.NX
            try:
                z_ref = oracle.solve_qp_active_set(H, g, E, d, lb, ub, off)
            except RuntimeError:
                # degenerate tick: the oracle's active-set method cycles
                # (multiple minimizers / ties at the bound) — report, skip,
                # and TALLY so the summary states exactly what was checked
                print(f"  [tick {t}] oracle active-set cycled "
                      f"(degenerate QP) — tick skipped")
                skipped += 1
                x = plant(x, out.u0)
                continue
            checked += 1
            u_ref = ut + z_ref[off:].reshape(spec.N, oracle.NU)
            x_ref = xt + z_ref[:off].reshape(spec.N + 1, oracle.NX)

            # the solver's step as a dense-QP point (same ordering)
            z_sol = np.concatenate([
                (np.asarray(out.x_plan) - xt).ravel(),
                (u_plan - ut).ravel()])
            obj_gap = qp_objective(H, g, z_sol) - qp_objective(H, g, z_ref)
            eq_res = np.abs(E @ z_sol - d).max()
            rows.append(dict(
                t=t,
                u0_err=np.abs(u_plan[0] - u_ref[0]).max(),
                plan_err=np.abs(u_plan - u_ref).max(),
                obj_gap=obj_gap,
                eq_res=eq_res,
                sat=sat,
            ))
        x = plant(x, out.u0)

    u0e = np.array([r["u0_err"] for r in rows])
    pe = np.array([r["plan_err"] for r in rows])
    og = np.array([r["obj_gap"] for r in rows])
    er = np.array([r["eq_res"] for r in rows])
    worst = int(np.argmax(u0e))
    print(f"\n[{label}] {steps} ticks, {sat_ticks} saturated (>5% bound)")
    print(f"  oracle coverage: checked {checked}/{checked + skipped} "
          f"candidate ticks ({skipped} skipped: oracle degenerate)")
    if skipped > 0.05 * max(checked + skipped, 1):
        print(f"  WARNING: >5% of ticks unchecked — the summary below "
              f"certifies only the checked subset")
    print(f"  u0 err:   max {u0e.max():.3e}  p99 {np.percentile(u0e, 99):.3e}"
          f"  ticks>1e-4: {int((u0e > 1e-4).sum())}")
    print(f"  plan err: max {pe.max():.3e}  ticks>1e-4: "
          f"{int((pe > 1e-4).sum())}")
    print(f"  obj gap:  max {og.max():.3e}  at worst-u0 tick "
          f"{rows[worst]['t']}: gap {og[worst]:.3e}, eq-res "
          f"{er[worst]:.2e}, sat {rows[worst]['sat']:.2f}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--jump", type=float, default=1.5)
    ap.add_argument("--check-every", type=int, default=1)
    args = ap.parse_args()

    spec = default_ocp(dtype=jnp.float64)
    configs = [
        (IPMConfig(iters=8), "default Mehrotra-8"),
        (IPMConfig(iters=8, escalate_iters=16), "8 + escalate16"),
        (IPMConfig(iters=8, escalate_iters=32), "8 + escalate32"),
    ]
    for cfg, label in configs:
        study(cfg, label, args.steps, args.jump, spec,
              check_every=args.check_every)


if __name__ == "__main__":
    main()
