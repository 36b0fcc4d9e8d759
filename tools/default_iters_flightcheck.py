"""Flight-relevance of the default solver's unconverged ticks (VERDICT r4
item 4).

tools/bangbang_cert.py proved the default 8-iteration IPM is genuinely
unconverged on active-set-discovery ticks of large transients (u0 off by
up to 15.8 kRPM on 18/150 ticks of the 1.5 m bang-bang study, objective
gap +324), and that 8+escalate32 is exact at every tick.  This study
answers the question that matters for choosing the DEFAULT: do those
unconverged ticks change the FLIGHT?  Run the 0.5 m and 1.5 m hover
transients closed-loop under both configs and compare trajectories —
per-tick position divergence, settling time, and closed-loop LQ cost —
not per-solve u0 error.

Usage: PYTHONPATH=. python tools/default_iters_flightcheck.py
Prints a summary table of both transients.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np          # noqa: E402
import jax.numpy as jnp     # noqa: E402

from crazyflie_nmpc_tpu.models import hover_state           # noqa: E402
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig            # noqa: E402
from crazyflie_nmpc_tpu.runtime.closed_loop import (        # noqa: E402
    LoopConfig,
    hover_regulation,
)
from crazyflie_nmpc_tpu.solver import default_ocp           # noqa: E402

SETPOINT = np.array([0.0, 0.0, 0.5])


def closed_loop_cost(spec, res):
    """LQ tracking cost of the realized trajectory (the objective the OCP
    minimizes, accumulated over the flight)."""
    Q = np.asarray(spec.cost.W)[:13, :13]
    R = np.asarray(spec.cost.W)[13:, 13:]
    xref = np.zeros(13)
    xref[:3] = SETPOINT
    xref[3] = 1.0
    uss = float(spec.params.hover_speed())
    dx = np.asarray(res.x) - xref
    du = np.asarray(res.u) - uss
    return float(np.einsum("ti,ij,tj->", dx, Q, dx)
                 + np.einsum("ti,ij,tj->", du, R, du))


def settling_tick(res, tol=0.01):
    """First tick after which |pos - setpoint| stays below tol."""
    err = np.linalg.norm(np.asarray(res.x)[:, :3] - SETPOINT, axis=1)
    above = np.nonzero(err > tol)[0]
    return int(above[-1] + 1) if len(above) else 0


def run(jump: float, steps: int = 400):
    spec = default_ocp(dtype=jnp.float64)
    x0 = hover_state(spec.params, dtype=jnp.float64).at[0].set(jump)
    out = {}
    for label, cfg in [
        ("default-8", IPMConfig(iters=8)),
        ("8+esc32", IPMConfig(iters=8, escalate_iters=32)),
    ]:
        res = hover_regulation(spec, x0, tuple(SETPOINT), steps=steps,
                               config=LoopConfig(ipm=cfg))
        out[label] = res
    a, b = out["default-8"], out["8+esc32"]
    dpos = np.linalg.norm(np.asarray(a.x)[:, :3] - np.asarray(b.x)[:, :3],
                          axis=1)
    du0 = np.abs(np.asarray(a.u_cmd) - np.asarray(b.u_cmd)).max(axis=1)
    spec_c = default_ocp(dtype=jnp.float64)
    ca, cb = closed_loop_cost(spec_c, a), closed_loop_cost(spec_c, b)
    print(f"\n=== {jump:.1f} m transient, {steps} ticks ===")
    print(f"  per-solve u0 divergence:    max {du0.max():.3e} kRPM "
          f"({int((du0 > 1e-4).sum())} ticks > 1e-4)")
    print(f"  trajectory divergence:      max {dpos.max():.3e} m "
          f"(tick {int(np.argmax(dpos))}); final {dpos[-1]:.3e} m")
    print(f"  settling (1 cm):            default-8 tick "
          f"{settling_tick(a)}, esc32 tick {settling_tick(b)}")
    print(f"  closed-loop LQ cost:        default-8 {ca:.6f}, "
          f"esc32 {cb:.6f}  (rel diff {abs(ca - cb) / cb:.2e})")
    err_a = np.linalg.norm(np.asarray(a.x)[-1, :3] - SETPOINT)
    err_b = np.linalg.norm(np.asarray(b.x)[-1, :3] - SETPOINT)
    print(f"  final position error:       default-8 {err_a:.2e} m, "
          f"esc32 {err_b:.2e} m")
    return dict(jump=jump, du0_max=float(du0.max()),
                dpos_max=float(dpos.max()), dpos_final=float(dpos[-1]),
                settle_a=settling_tick(a), settle_b=settling_tick(b),
                cost_a=ca, cost_b=cb)


def main():
    rows = [run(0.5), run(1.5)]
    print("\nSummary:")
    print("| transient | max u0 div [kRPM] | max traj div [m] | "
          "final div [m] | settling (8 vs esc32) | LQ cost rel diff |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['jump']:.1f} m | {r['du0_max']:.2e} | "
              f"{r['dpos_max']:.2e} | {r['dpos_final']:.2e} | "
              f"{r['settle_a']} vs {r['settle_b']} | "
              f"{abs(r['cost_a'] - r['cost_b']) / r['cost_b']:.2e} |")


if __name__ == "__main__":
    main()
