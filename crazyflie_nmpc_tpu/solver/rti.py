"""Real-time-iteration SQP: one prepare+feedback Gauss-Newton step.

The TPU-native equivalent of the reference's per-tick `acados_solve()`
(acados_mpc.cpp:611, solver type SQP_RTI, generate_c_code.py:146): a single
Gauss-Newton SQP iteration per control period, warm-started from the
previous solution.  acados keeps the primal iterate implicitly inside
`nlp_out` across calls (SURVEY.md section 5, checkpoint/resume); here that
carried state is explicit and functional:

    (RTIState, x0, yref) -> (RTIState', RTIOutput)

so it jit/vmap/scan-composes, checkpoints trivially (it's just arrays), and
batches across drones/scenarios.

Robustness note: like acados' RTI, there is no globalization — one
Gauss-Newton step per tick with a fixed QP iteration budget.  On aggressive
transients an under-provisioned configuration (very short horizons N<~15
combined with a starved IPM budget <~8 iterations in f32) can leave the QP
under-converged, degrade the carried warm start, and self-reinforce.  The
reference problem's envelope (N=50, 8+ iterations) is comfortably stable in
all closed-loop tests; `runtime.closed_loop.LoopConfig.guard_failures`
additionally holds the last action if a solve ever goes non-finite
(the reference's failed-solve behavior, acados_mpc.cpp:714-717).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.ops.backend import highest_precision
from crazyflie_nmpc_tpu.ops.integrators import linearize_trajectory, rollout
from crazyflie_nmpc_tpu.ops.qp import build_qp, gauss_newton_cost_blocks
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RTIState:
    """Warm-start iterate carried across RTI calls (primal trajectory)."""

    x_traj: Any  # (N+1, nx)
    u_traj: Any  # (N, nu)


class RTIOutput(NamedTuple):
    """Per-solve outputs mirroring the reference's extraction
    (acados_mpc.cpp:614-625): stage-0/1 controls, stage-4 state for 60 ms
    delay compensation, the full open-loop plan, and solver diagnostics."""

    u0: Any       # (nu,) first control
    u1: Any       # (nu,) second control (delay-compensated command)
    x_plan: Any   # (N+1, nx) open-loop state plan
    u_plan: Any   # (N, nu) open-loop control plan
    kkt_res: Any  # scalar: residual diagnostic (cf. nlp_out->inf_norm_res)
    qp_mu: Any    # scalar: final IPM complementarity gap

    def x_at(self, stage: int):
        """Predicted state `stage` steps ahead (stage 4 = +60 ms at 15 ms)."""
        return self.x_plan[stage]


def init_rti(spec: OCPSpec, x0: jax.Array) -> RTIState:
    """Initialize the warm start: steady-input rollout from x0.

    The reference leaves nlp_out zero-initialized and lets early RTI steps
    pull it in; a steady-state-input rollout (hover for the quadrotor) is a
    strictly better-conditioned start and converges to the same fixed point
    (tested in test_rti.py).
    """
    uss = spec.steady_input(x0.dtype)
    u_traj = jnp.broadcast_to(uss, (spec.N,) + uss.shape).astype(x0.dtype)
    x_traj = rollout(spec.ode(), spec.params, x0, u_traj, spec.dt,
                     spec.sim_steps)
    return RTIState(x_traj=x_traj, u_traj=u_traj)


@highest_precision
def rti_step(spec: OCPSpec, state: RTIState, x0: jax.Array,
             yref: jax.Array, yref_e: jax.Array,
             config: ipm.IPMConfig = ipm.IPMConfig()):
    """One SQP-RTI iteration: linearize at the iterate, solve the QP, take a
    full Newton-type step.

    Args:
      x0: (nx,) current state estimate (becomes the lbx0=ubx0 equality).
      yref: (N, ny) stage references; yref_e: (nx,) terminal reference.
    Returns (RTIState', RTIOutput).
    """
    # --- preparation phase: stage-parallel linearization (vmap over stages)
    x_next, A, B = linearize_trajectory(
        spec.ode(), spec.params, state.x_traj, state.u_traj, spec.dt,
        spec.sim_steps)

    cost = spec.cost
    blocks = gauss_newton_cost_blocks(
        cost.W, cost.Vx, cost.Vu, cost.W_e, cost.Vx_e,
        state.x_traj, state.u_traj, yref, yref_e)

    qp = build_qp(A, B, x_next, state.x_traj, state.u_traj, x0,
                  spec.lbu, spec.ubu, blocks)

    # --- feedback phase: structured IPM solve + full-step update
    sol = ipm.solve(qp, config)
    x_traj = state.x_traj + sol.dx
    u_traj = state.u_traj + sol.du

    # NLP-level residual (cf. acados nlp_out->inf_norm_res,
    # acados_mpc.cpp:614-616): nonlinear dynamics infeasibility at the
    # linearization point plus the Newton step norm — both vanish exactly at
    # an NLP KKT point, so repeated RTI steps report contraction.
    res_nl = jnp.maximum(jnp.max(jnp.abs(qp.c)), jnp.max(jnp.abs(qp.dx0)))
    step_norm = jnp.maximum(jnp.max(jnp.abs(sol.du)),
                            jnp.max(jnp.abs(sol.dx)))

    new_state = RTIState(x_traj=x_traj, u_traj=u_traj)
    out = RTIOutput(
        u0=u_traj[0],
        u1=u_traj[1],
        x_plan=x_traj,
        u_plan=u_traj,
        kkt_res=jnp.maximum(res_nl, step_norm),
        qp_mu=sol.stats["mu"],
    )
    return new_state, out


@highest_precision
def sqp_solve(spec: OCPSpec, state: RTIState, x0, yref, yref_e,
              iters: int = 10, config: ipm.IPMConfig = ipm.IPMConfig()):
    """Full SQP: iterate rti_step to convergence on a fixed problem.

    The reference exposes this as the commented-out 'SQP' solver option
    (generate_c_code.py:147); used in tests as the converged-NLP ground
    truth that RTI tracks.
    """
    def body(st, _):
        st, out = rti_step(spec, st, x0, yref, yref_e, config)
        return st, out.kkt_res

    state, kkts = jax.lax.scan(body, state, None, length=iters)
    return state, kkts


@highest_precision
def as_rti_prepare(spec: OCPSpec, state: RTIState, x0_pred, yref, yref_e,
                   prep_iters: int = 1,
                   config: ipm.IPMConfig = ipm.IPMConfig()) -> RTIState:
    """Advanced-Step RTI preparation (arXiv:2403.07101, levels C/D).

    Between samples, run `prep_iters` extra SQP iterations on the OCP
    anchored at the *predicted* next measurement `x0_pred` (from the delay
    predictor / plant model).  The feedback phase at the next sample then
    starts from an iterate that has already absorbed most of the nonlinear
    contraction, tightening RTI toward the converged-SQP solution at the
    cost of off-critical-path compute — the reference's plain RTI is the
    prep_iters = 0 special case.  Level mapping: 1 iteration ~ AS-RTI-C;
    iterating to tolerance ~ AS-RTI-D.
    """
    state, _ = sqp_solve(spec, state, x0_pred, yref, yref_e,
                         iters=prep_iters, config=config)
    return state


@highest_precision
def as_rti_step(spec: OCPSpec, state: RTIState, x0, x0_pred_next,
                yref, yref_e, config: ipm.IPMConfig = ipm.IPMConfig(),
                prep_iters: int = 1):
    """One AS-RTI cycle: feedback at the actual estimate, then advanced-step
    preparation at the predicted next one.

    Returns (prepared RTIState for the next tick, RTIOutput of this tick).
    """
    state, out = rti_step(spec, state, x0, yref, yref_e, config)
    state = as_rti_prepare(spec, state, x0_pred_next, yref, yref_e,
                           prep_iters, config)
    return state, out
