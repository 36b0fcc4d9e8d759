"""Riccati-recursion solver for equality-constrained LQ problems.

This is the TPU-native equivalent of the block linear algebra inside HPIPM
(the reference's QP backend, generate_c_code.py:140 'PARTIAL_CONDENSING_HPIPM'
+ SURVEY.md section 2.3): each interior-point iteration reduces to an
equality-constrained affine-LQ solve, performed here as a backward value-
function recursion and a forward rollout, both as `lax.scan`s over the
horizon.  The factorization (P_k, K_k, chol(Quu_k)) is separated from the
affine/vector pass so a Mehrotra predictor-corrector can reuse one
factorization for two right-hand sides.

Problem solved (dims: N stages, nx states, nu inputs):

  min  sum_k 1/2 dx_k'Qxx_k dx_k + 1/2 du_k'Ruu_k du_k + du_k'S_k dx_k
             + qx_k'dx_k + ru_k'du_k
       + 1/2 dx_N'P dx_N + p'dx_N
  s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 given.

All functions operate on one problem; batching is `vmap` over whole solves.
A parallel-in-N associative-scan variant lives in `ops/riccati_pscan.py`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from crazyflie_nmpc_tpu.ops.backend import highest_precision


class RiccatiFactors(NamedTuple):
    """Horizon-stacked factorization of the LQ problem.

    P:    (N+1, nx, nx) cost-to-go Hessians (P[N] = terminal).
    K:    (N, nu, nx)   feedback gains  du = K dx + k.
    Quu_chol: (N, nu, nu) lower-triangular Cholesky factors of
              Quu_k = Ruu_k + B_k'P_{k+1}B_k.
    """

    P: Any
    K: Any
    Quu_chol: Any


@highest_precision
def factorize(A, B, Qxx, Ruu, S, P_term):
    """Backward Riccati factorization (quadratic terms only).

    Sequential in N by nature (`lax.scan` reversed); every step is a handful
    of (nx,nx)/(nx,nu) matmuls which XLA batches across vmapped solves.
    """
    def step(P_next, blk):
        A_k, B_k, Qxx_k, Ruu_k, S_k = blk
        PA = P_next @ A_k                      # (nx, nx)
        PB = P_next @ B_k                      # (nx, nu)
        Quu = Ruu_k + B_k.T @ PB               # (nu, nu)
        Qux = S_k + B_k.T @ PA                 # (nu, nx)
        Quu_cf = cho_factor(Quu, lower=True)
        K = -cho_solve(Quu_cf, Qux)            # (nu, nx)
        P = Qxx_k + A_k.T @ PA + Qux.T @ K
        P = 0.5 * (P + P.T)
        return P, (P, K, Quu_cf[0])

    P0, (Ps, Ks, Quu_chols) = jax.lax.scan(
        step, P_term, (A, B, Qxx, Ruu, S), reverse=True)
    P_all = jnp.concatenate([Ps, P_term[None]], axis=0)
    return RiccatiFactors(P=P_all, K=Ks, Quu_chol=Quu_chols)


@highest_precision
def backward_vector(factors: RiccatiFactors, A, B, qx, ru, c, p_term):
    """Backward pass for the affine terms given an existing factorization.

    Uses the identity Qux'k_ff = K'Qu so the cross term S is not needed here.
    Returns (k (N, nu) feedforward terms, p (N+1, nx) cost-to-go gradients).
    """
    def step(p_next, blk):
        A_k, B_k, qx_k, ru_k, c_k, P_next, K_k, L_k = blk
        m = p_next + P_next @ c_k
        Qu = ru_k + B_k.T @ m
        kff = -cho_solve((L_k, True), Qu)
        p = qx_k + A_k.T @ m + K_k.T @ Qu
        return p, (kff, p)

    P_next_all = factors.P[1:]
    p0, (ks, ps) = jax.lax.scan(
        step, p_term, (A, B, qx, ru, c, P_next_all, factors.K,
                       factors.Quu_chol),
        reverse=True)
    p_all = jnp.concatenate([ps, p_term[None]], axis=0)
    return ks, p_all


@highest_precision
def forward_rollout(factors: RiccatiFactors, k_ff, A, B, c, dx0):
    """Forward pass: dx_{k+1} = A dx + B du + c with du = K dx + k."""
    def step(dx, blk):
        A_k, B_k, c_k, K_k, k_k = blk
        du = K_k @ dx + k_k
        dx_next = A_k @ dx + B_k @ du + c_k
        return dx_next, (dx, du)

    dx_N, (dxs, dus) = jax.lax.scan(step, dx0, (A, B, c, factors.K, k_ff))
    dx_all = jnp.concatenate([dxs, dx_N[None]], axis=0)
    return dx_all, dus


@highest_precision
def solve_lq(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term, dx0):
    """One-shot equality-constrained affine-LQ solve.

    Returns (dx (N+1, nx), du (N, nu)) minimizing the LQ objective subject to
    the affine dynamics and fixed dx0.
    """
    factors = factorize(A, B, Qxx, Ruu, S, P_term)
    k_ff, _ = backward_vector(factors, A, B, qx, ru, c, p_term)
    return forward_rollout(factors, k_ff, A, B, c, dx0)
