"""Multistage (OCP-structured) QP data containers and Gauss-Newton builders.

The QP solved at every RTI iteration (the role of acados' ocp_qp + HPIPM in
the reference, acados_mpc.cpp:611 `acados_solve()`):

  min   sum_k 1/2 [dx_k;du_k]' [Qxx_k S_k'; S_k Ruu_k] [dx_k;du_k]
                 + qx_k'dx_k + ru_k'du_k
        + 1/2 dx_N' P dx_N + p'dx_N
  s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,   k = 0..N-1
        dx_0     = dx0                       (initial-state equality,
                                              lbx0=ubx0 in the reference)
        lb_k <= du_k <= ub_k                 (input box, relative to iterate)

All arrays are stage-stacked along axis 0, so every consumer can vmap over
stages and every solver can scan over them.  A leading batch axis on top of
that comes from vmapping whole QPs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops.backend import highest_precision


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QPData:
    """Stage-structured LQ problem data (shapes for horizon N, dims nx/nu)."""

    A: Any    # (N, nx, nx) discrete dynamics Jacobian dF/dx
    B: Any    # (N, nx, nu) discrete dynamics Jacobian dF/du
    c: Any    # (N, nx)     dynamics defect F(x_k,u_k) - x_{k+1}
    Qxx: Any  # (N, nx, nx) stage state Hessian
    qx: Any   # (N, nx)     stage state gradient
    Ruu: Any  # (N, nu, nu) stage input Hessian
    ru: Any   # (N, nu)     stage input gradient
    S: Any    # (N, nu, nx) stage cross Hessian (d^2/du dx)
    P: Any    # (nx, nx)    terminal Hessian
    p: Any    # (nx,)       terminal gradient
    lb: Any   # (N, nu)     lower input bound (relative to iterate)
    ub: Any   # (N, nu)     upper input bound (relative to iterate)
    dx0: Any  # (nx,)       fixed initial state deviation

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]


@highest_precision
def gauss_newton_cost_blocks(W, Vx, Vu, W_e, Vx_e, x_traj, u_traj,
                             yref, yref_e):
    """Gauss-Newton Hessian/gradient blocks of the linear-least-squares cost.

    Cost (generate_c_code.py:62-129): sum_k 1/2 |Vx x_k + Vu u_k - yref_k|^2_W
    + 1/2 |Vx_e x_N - yref_e|^2_{W_e}.  The GN Hessian is iterate-independent:
      Qxx = Vx'WVx,  Ruu = Vu'WVu,  S = Vu'WVx,  P = Vx_e'W_e Vx_e
    and gradients are residual-weighted.

    Args:
      x_traj (N+1, nx), u_traj (N, nu): current iterate.
      yref (N, ny), yref_e (nx_e,): references.
    Returns dict of stage-stacked blocks (Qxx, qx, Ruu, ru, S, P, p).
    """
    N = u_traj.shape[0]
    WVx = W @ Vx
    WVu = W @ Vu
    Qxx = Vx.T @ WVx
    Ruu = Vu.T @ WVu
    S = Vu.T @ WVx

    # residuals y_k - yref_k, all stages at once
    y = x_traj[:-1] @ Vx.T + u_traj @ Vu.T        # (N, ny)
    e = y - yref                                   # (N, ny)
    qx = e @ WVx                                   # (N, nx)
    ru = e @ WVu                                   # (N, nu)

    P = Vx_e.T @ W_e @ Vx_e
    e_N = x_traj[-1] @ Vx_e.T - yref_e
    p = Vx_e.T @ (W_e @ e_N)

    return dict(
        Qxx=jnp.broadcast_to(Qxx, (N,) + Qxx.shape),
        qx=qx,
        Ruu=jnp.broadcast_to(Ruu, (N,) + Ruu.shape),
        ru=ru,
        S=jnp.broadcast_to(S, (N,) + S.shape),
        P=P,
        p=p,
    )


@highest_precision
def build_qp(A, B, x_next_pred, x_traj, u_traj, x0, lbu, ubu, cost_blocks):
    """Assemble the full RTI QP from linearization + cost blocks.

    Args:
      A, B: (N, nx, nx), (N, nx, nu) from `linearize_trajectory`.
      x_next_pred: (N, nx) F(x_k, u_k) from the same call.
      x_traj, u_traj: current iterate.
      x0: (nx,) measured/estimated initial state (the lbx0=ubx0 equality,
          acados_mpc.cpp:581-582).
      lbu, ubu: absolute input bounds, scalars or (nu,)/(N, nu).
      cost_blocks: dict from `gauss_newton_cost_blocks`.
    """
    c = x_next_pred - x_traj[1:]
    dx0 = x0 - x_traj[0]
    lb = jnp.broadcast_to(lbu, u_traj.shape) - u_traj
    ub = jnp.broadcast_to(ubu, u_traj.shape) - u_traj
    return QPData(A=A, B=B, c=c, lb=lb, ub=ub, dx0=dx0, **cost_blocks)
