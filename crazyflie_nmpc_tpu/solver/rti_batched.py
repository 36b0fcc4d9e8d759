"""Throughput-oriented batched RTI step.

The production serving path (BASELINE.json configs 3-5): many independent
NMPC instances advanced one SQP-RTI iteration per call.  Mathematically
identical to vmap(rti_step) with the XLA IPM backend — the difference is
the layout and structure: a stage-parallel preparation phase with the
hand-derived sparse VDE and block-2 condensing (`ops.prep`), then the
batch-last IPM (`ops.ipm_fast`), whose Riccati sweeps run as one kernel
launch each on a GPU.

Layouts: the default API is batch-FIRST (compatible with
`solver.rti.RTIState` pytrees); the solver wants batch-LAST.  A serving
loop that chains steps device-side should pass `layout="batch_last"` and
carry batch-last states — that removes two layout transposes per tick;
the whole pipeline then runs batch-last end to end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.models.quadrotor import dynamics
from crazyflie_nmpc_tpu.ops import ipm, ipm_fast, prep
from crazyflie_nmpc_tpu.ops.integrators import linearize_trajectory
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.rti import RTIOutput, RTIState


def to_batch_last(states: RTIState) -> RTIState:
    """Convert a batch-first RTIState to the kernel (batch-last) layout."""
    return RTIState(x_traj=jnp.moveaxis(states.x_traj, 0, -1),
                    u_traj=jnp.moveaxis(states.u_traj, 0, -1))


def to_batch_first(states: RTIState) -> RTIState:
    return RTIState(x_traj=jnp.moveaxis(states.x_traj, -1, 0),
                    u_traj=jnp.moveaxis(states.u_traj, -1, 0))


def rti_step_batched(spec: OCPSpec, states: RTIState, x0s: jax.Array,
                     yref: jax.Array, yref_e: jax.Array,
                     config: ipm.IPMConfig = ipm.IPMConfig(),
                     condense: int | None = None,
                     layout: str = "batch_first",
                     prep_vde_order: int = 4,
                     sweep: str | None = None):
    """One RTI iteration for a batch of problems.

    Args:
      states: RTIState with leading batch axis (x_traj (B,N+1,nx),
        u_traj (B,N,nu)) — or trailing batch axis with layout="batch_last"
        (x_traj (N+1,nx,B), u_traj (N,nu,B)).
      x0s: (B, nx).  yref: (N, ny) shared or (B, N, ny) per-problem;
      yref_e likewise.
      condense: None (default) selects block-2 partial condensing whenever
        the horizon is even — the production path (exact); pass 1 to
        force the uncondensed recursion.
      prep_vde_order: 4 (default) = exact ERK4 matrix VDE sensitivities;
        2 = midpoint 2nd-order sensitivities on the exact ERK4 state
        propagation (inexact-Jacobian Gauss-Newton, opt-in).
      sweep: "kernel" / "plain" / "interpret", see `ops.ipm_fast`;
        None lets `ops.backend.sweep_backend` decide from the platform.
    Returns (RTIState', RTIOutput) in the same layout as the input
    (batch_last: u0/u1 are (nu,B), plans are stage-major batch-last).
    """
    if condense is None:
        condense = 2 if spec.N % 2 == 0 else 1
    if spec.f is not None:
        raise ValueError(
            "rti_step_batched is specialized to the Crazyflie quadrotor "
            "(hand-derived sparse Jacobians); custom-model specs (spec.f "
            "set) use solver.rti.rti_step, batched with jax.vmap.")
    B = x0s.shape[0]
    cost = spec.cost
    batch_last = layout == "batch_last"
    bl = lambda z: jnp.moveaxis(z, 0, -1)          # batch-first -> last

    x_bl = states.x_traj if batch_last else bl(states.x_traj)  # (N+1,nx,B)
    u_bl = states.u_traj if batch_last else bl(states.u_traj)  # (N,nu,B)
    nx = x_bl.shape[1]
    nu = u_bl.shape[1]
    N = u_bl.shape[0]
    dtype = x_bl.dtype

    # --- batch-last diagonal QP assembly: the reference cost is LLS with
    # selector Vx/Vu and diagonal W (generate_c_code.py:86-107), so
    # qx = q ⊙ (x - yref_x), ru = r ⊙ (u - yref_u), Hessians are the
    # broadcast diagonals.
    q_diag = jnp.diagonal(cost.W)[:nx].astype(dtype)
    r_diag = jnp.diagonal(cost.W)[nx:].astype(dtype)
    pT_diag = jnp.diagonal(cost.W_e).astype(dtype)

    if yref.ndim == 2:  # shared across the batch
        yref_bl = jnp.broadcast_to(yref[:, :, None], (N, nx + nu, B))
        yref_e_bl = jnp.broadcast_to(yref_e[:, None], (nx, B))
    else:
        yref_bl = jnp.moveaxis(yref, 0, -1)
        yref_e_bl = jnp.moveaxis(yref_e, 0, -1)
    yref_bl = yref_bl.astype(dtype)

    p = pT_diag[:, None] * (x_bl[-1] - yref_e_bl)          # (nx, B)
    dx0_bl = bl(x0s) - x_bl[0]
    common = dict(
        ruu=jnp.broadcast_to(r_diag[None, :, None], (N, nu, B)),
        pT=jnp.broadcast_to(pT_diag[:, None], (nx, B)),
        p=p,
        dx0=dx0_bl,
    )

    if spec.sim_steps == 1:
        # preparation phase: ERK4 + sparse analytic VDE + assembly, stage-
        # parallel (ops.prep); condensed in the same function when the
        # solver runs block-2 condensing
        par = spec.params
        params = jnp.stack([jnp.asarray(v, dtype)
                            for v in (par.g0, par.mq, par.Ixx, par.Iyy,
                                      par.Izz, par.Cd, par.Ct, par.l,
                                      spec.dt)])
        lbu = jnp.broadcast_to(spec.lbu, (nu,)).astype(dtype)
        ubu = jnp.broadcast_to(spec.ubu, (nu,)).astype(dtype)
        prep_args = (x_bl, u_bl, yref_bl, q_diag, r_diag, lbu, ubu, params)
        if condense == 2:
            cnd, Ae, Be, c_k, lb_k, ub_k = prep.prep_condense2(
                *prep_args, vde_order=prep_vde_order)
            qp = dict(
                c=c_k, lb=lb_k, ub=ub_k,
                c2Ae=Ae, c2Be=Be,
                **{"c2" + k: v for k, v in cnd.items()},
                **common)
        else:
            A_k, B_k, c_k, qx_k, ru_k, lb_k, ub_k = prep.prep(
                *prep_args, vde_order=prep_vde_order)
            qp = dict(
                A=A_k, B=B_k, c=c_k, qx=qx_k, ru=ru_k, lb=lb_k, ub=ub_k,
                qxx=jnp.broadcast_to(q_diag[None, :, None], (N, nx, B)),
                **common)
    else:
        # general sim_steps path: stage-parallel jacfwd linearization,
        # batch-first under vmap
        x_bf = states.x_traj if not batch_last else jnp.moveaxis(x_bl, -1, 0)
        u_bf = states.u_traj if not batch_last else jnp.moveaxis(u_bl, -1, 0)
        x_next, A, Bm = jax.vmap(
            lambda xt, ut: linearize_trajectory(dynamics, spec.params, xt,
                                                ut, spec.dt, spec.sim_steps)
        )(x_bf, u_bf)
        yref_bf = jnp.moveaxis(yref_bl, -1, 0)             # (B, N, ny)
        qx = q_diag * (x_bf[:, :-1] - yref_bf[..., :nx])
        ru = r_diag * (u_bf - yref_bf[..., nx:])
        qp = dict(
            A=bl(A), B=bl(Bm),
            c=bl(x_next - x_bf[:, 1:]),
            qxx=jnp.broadcast_to(q_diag[None, :, None], (N, nx, B)),
            qx=bl(qx),
            ru=bl(ru),
            lb=bl(spec.lbu - u_bf),
            ub=bl(spec.ubu - u_bf),
            **common,
        )

    # --- feedback: batch-last IPM
    sol = ipm_fast.solve_batched(qp, config, condense=condense,
                                 sweep=sweep)
    x_traj_bl = x_bl + sol.dx
    u_traj_bl = u_bl + sol.du

    res_nl = jnp.maximum(jnp.max(jnp.abs(qp["c"]), axis=(0, 1)),
                         jnp.max(jnp.abs(qp["dx0"]), axis=0))
    step_norm = jnp.maximum(jnp.max(jnp.abs(sol.du), axis=(0, 1)),
                            jnp.max(jnp.abs(sol.dx), axis=(0, 1)))
    kkt_res = jnp.maximum(res_nl, step_norm)

    if batch_last:
        new_states = RTIState(x_traj=x_traj_bl, u_traj=u_traj_bl)
        out = RTIOutput(
            u0=u_traj_bl[0],
            u1=u_traj_bl[1],
            x_plan=x_traj_bl,
            u_plan=u_traj_bl,
            kkt_res=kkt_res,
            qp_mu=sol.stats["mu"],
        )
        return new_states, out

    x_traj = jnp.moveaxis(x_traj_bl, -1, 0)
    u_traj = jnp.moveaxis(u_traj_bl, -1, 0)
    new_states = RTIState(x_traj=x_traj, u_traj=u_traj)
    out = RTIOutput(
        u0=u_traj[:, 0],
        u1=u_traj[:, 1],
        x_plan=x_traj,
        u_plan=u_traj,
        kkt_res=kkt_res,
        qp_mu=sol.stats["mu"],
    )
    return new_states, out
