"""Partial condensing: reduce N stages to N/b blocks with wide inputs.

The TPU-native equivalent of HPIPM's partial condensing (the reference's QP
backend is 'PARTIAL_CONDENSING_HPIPM', generate_c_code.py:140; Frison's
Hessian-condensing algorithm is name-checked in README.md:77).  Within each
block of `b` consecutive stages, the intermediate states are eliminated by
forward substitution:

    dx_j = Phi_j dx + Gamma_j v + h_j,    v = [du_0; ...; du_{b-1}]

yielding a reduced multistage QP with N/b stages, state dim nx and input dim
b*nu.  Box bounds on du map 1:1 onto v, so the reduced problem is solved by
the *same* structure-exploiting IPM (`ops.ipm` is dimension-agnostic), and
the full-horizon solution is recovered by block-local expansion.

Why this is the TPU layout (SURVEY.md section 2.6 'stage axis'):
  * condensing is embarrassingly parallel over blocks -> `vmap`, turning N
    tiny (13x13) matmuls into N/b batched (13 x b*nu) matmuls that tile far
    better onto the MXU;
  * the sequential Riccati critical path shrinks from N to N/b;
  * across devices, each device condenses its local blocks and only the
    small reduced problem crosses the interconnect (parallel/stage_sharded).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops.backend import highest_precision
from crazyflie_nmpc_tpu.ops.qp import QPData


class BlockMaps(NamedTuple):
    """Per-block substitution maps needed to expand the reduced solution.

    Shapes (M blocks, b stages/block): Phi (M, b, nx, nx),
    Gamma (M, b, nx, b*nu), h (M, b, nx).
    """

    Phi: jax.Array
    Gamma: jax.Array
    h: jax.Array


@highest_precision
def _condense_block(A, B, c, Qxx, qx, Ruu, ru, S):
    """Condense one block of b stages. Inputs are (b, ...) stage-stacked."""
    b, nx, nu = B.shape[0], B.shape[1], B.shape[2]
    nv = b * nu
    dtype = A.dtype

    # forward substitution maps for dx_j, j = 0..b  (j=b is the block exit)
    def sub_step(carry, blk):
        Phi_j, Gamma_j, h_j, j = carry
        A_j, B_j, c_j = blk
        Phi_n = A_j @ Phi_j
        Gamma_n = A_j @ Gamma_j
        # insert B_j into column block j of Gamma
        Gamma_n = jax.lax.dynamic_update_slice(
            Gamma_n, B_j, (0, j * nu))
        h_n = A_j @ h_j + c_j
        return (Phi_n, Gamma_n, h_n, j + 1), (Phi_j, Gamma_j, h_j)

    init = (jnp.eye(nx, dtype=dtype), jnp.zeros((nx, nv), dtype),
            jnp.zeros((nx,), dtype), 0)
    (Phi_b, Gamma_b, h_b, _), (Phis, Gammas, hs) = jax.lax.scan(
        sub_step, init, (A, B, c))

    # accumulate the condensed cost blocks over the b interior stages
    def cost_step(carry, blk):
        Qbar, Rbar, Sbar, qbar, rbar, j = carry
        Phi_j, Gamma_j, h_j, Q_j, q_j, R_j, r_j, S_j = blk
        QPhi = Q_j @ Phi_j                    # (nx, nx)
        QGam = Q_j @ Gamma_j                  # (nx, nv)
        Qh_q = Q_j @ h_j + q_j                # (nx,)
        Qbar = Qbar + Phi_j.T @ QPhi
        Rbar = Rbar + Gamma_j.T @ QGam
        Sbar = Sbar + Gamma_j.T @ QPhi
        qbar = qbar + Phi_j.T @ Qh_q
        rbar = rbar + Gamma_j.T @ Qh_q
        # du_j' S_j dx_j  and  1/2 du_j' R_j du_j + r_j' du_j
        SPhi = S_j @ Phi_j                    # (nu, nx)
        SGam = S_j @ Gamma_j                  # (nu, nv)
        Sbar = jax.lax.dynamic_update_slice(
            Sbar, jax.lax.dynamic_slice(Sbar, (j * nu, 0), (nu, nx)) + SPhi,
            (j * nu, 0))
        cross = jnp.zeros((nv, nv), dtype)
        cross = jax.lax.dynamic_update_slice(cross, SGam, (j * nu, 0))
        Rbar = Rbar + cross + cross.T
        Rblk = jnp.zeros((nv, nv), dtype)
        Rblk = jax.lax.dynamic_update_slice(Rblk, R_j, (j * nu, j * nu))
        Rbar = Rbar + Rblk
        radd = r_j + S_j @ h_j
        rbar = jax.lax.dynamic_update_slice(
            rbar, jax.lax.dynamic_slice(rbar, (j * nu,), (nu,)) + radd,
            (j * nu,))
        return (Qbar, Rbar, Sbar, qbar, rbar, j + 1), None

    cost_init = (jnp.zeros((nx, nx), dtype), jnp.zeros((nv, nv), dtype),
                 jnp.zeros((nv, nx), dtype), jnp.zeros((nx,), dtype),
                 jnp.zeros((nv,), dtype), 0)
    (Qbar, Rbar, Sbar, qbar, rbar, _), _ = jax.lax.scan(
        cost_step, cost_init, (Phis, Gammas, hs, Qxx, qx, Ruu, ru, S))

    return (Phi_b, Gamma_b, h_b, Qbar, qbar, Rbar, rbar, Sbar,
            Phis, Gammas, hs)


@highest_precision
def condense(qp: QPData, block: int):
    """Partially condense `qp` with block size b (must divide N).

    Returns (reduced QPData with N/b stages and b*nu-wide inputs, BlockMaps
    for expansion).
    """
    N, nx = qp.c.shape[0], qp.c.shape[1]
    nu = qp.ru.shape[-1]
    if N % block != 0:
        raise ValueError(f"block {block} must divide horizon {N}")
    M = N // block

    def reshape_blocks(x):
        return x.reshape((M, block) + x.shape[1:])

    (Ab, Bb, cb, Qb, qb, Rb, rb, Sb, Phis, Gammas, hs) = jax.vmap(
        _condense_block)(
        reshape_blocks(qp.A), reshape_blocks(qp.B), reshape_blocks(qp.c),
        reshape_blocks(qp.Qxx), reshape_blocks(qp.qx),
        reshape_blocks(qp.Ruu), reshape_blocks(qp.ru), reshape_blocks(qp.S))

    reduced = QPData(
        A=Ab, B=Bb, c=cb,
        Qxx=Qb, qx=qb, Ruu=Rb, ru=rb, S=Sb,
        P=qp.P, p=qp.p,
        lb=reshape_blocks(qp.lb).reshape(M, block * nu),
        ub=reshape_blocks(qp.ub).reshape(M, block * nu),
        dx0=qp.dx0,
    )
    return reduced, BlockMaps(Phi=Phis, Gamma=Gammas, h=hs)


@highest_precision
def expand(maps: BlockMaps, dx_red: jax.Array, v_red: jax.Array):
    """Recover the full-horizon solution from the reduced one.

    Args:
      dx_red: (M+1, nx) reduced states (block entry states + final).
      v_red:  (M, b*nu) reduced inputs.
    Returns (dx (N+1, nx), du (N, nu)).
    """
    M, b, nx = maps.Phi.shape[0], maps.Phi.shape[1], maps.Phi.shape[2]
    nu = maps.Gamma.shape[-1] // b

    def block_states(Phi, Gamma, h, dx_m, v_m):
        # dx_j = Phi_j dx + Gamma_j v + h_j for j = 0..b-1
        return (jnp.einsum("jab,b->ja", Phi, dx_m)
                + jnp.einsum("jav,v->ja", Gamma, v_m) + h)

    dx_inner = jax.vmap(block_states)(maps.Phi, maps.Gamma, maps.h,
                                      dx_red[:-1], v_red)   # (M, b, nx)
    dx_full = jnp.concatenate(
        [dx_inner.reshape(M * b, nx), dx_red[-1][None]], axis=0)
    du_full = v_red.reshape(M * b, nu)
    return dx_full, du_full


@highest_precision
def solve_partial(qp: QPData, block: int, config=None):
    """Solve `qp` by partial condensing + structured IPM + expansion.

    Drop-in alternative to `ipm.solve` (same IPMSolution contract; bound
    duals are reshaped back to per-stage (N, nu)).
    """
    from crazyflie_nmpc_tpu.ops import ipm  # local import, no cycle

    config = config or ipm.IPMConfig()
    N = qp.c.shape[0]
    nu = qp.ru.shape[-1]
    reduced, maps = condense(qp, block)
    sol = ipm.solve(reduced, config)
    dx_full, du_full = expand(maps, sol.dx, sol.du)
    return ipm.IPMSolution(
        dx=dx_full, du=du_full,
        lam_l=sol.lam_l.reshape(N, nu),
        lam_u=sol.lam_u.reshape(N, nu),
        stats=sol.stats)
