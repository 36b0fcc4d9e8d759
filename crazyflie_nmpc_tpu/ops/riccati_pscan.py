"""Associative-scan Riccati: log-depth backward pass over the horizon.

STATUS: research module — correct (parity-tested vs `ops.riccati`) but
NOT wired into any product path, by measurement.  The B=1 latency
crossover it was built for was not found on the accelerator the system
was first written for: the sequential XLA sweep beat this scan at every
horizon tested (N=50..3200), the ~4x per-stage FLOP overhead of the
combine elements dominating.  Not yet measured on a GPU, where the
sequential scan is launch-bound (PERF.md, open questions).  Kept as the
horizon-parallel construction a future multi-chip-stage-axis latency
path would start from (and as the recorded negative result).

The sequential Riccati recursion (`ops.riccati`, and HPIPM inside the
reference) is O(N) *depth* — fine for throughput (batch rides the vector
lanes while stages run in sequence) but the wrong shape for latency at
large N or for sharding the horizon axis.  This module reformulates the
backward pass as an ASSOCIATIVE operation on per-stage "conditional
value-function" elements, so `jax.lax.associative_scan` evaluates all N
cost-to-go functions in O(log N) depth — the temporal-parallelization
construction of Särkkä & García-Fernández (parallel LQT; see PAPERS.md) —
and the forward rollout parallelizes the same way as a composition of
affine maps.  This is the project's sequence-parallel axis taken to its
limit (SURVEY.md §2.6/§7: the horizon is the "long-context" analog).

Math.  A stage with dynamics z = A x + B u + c and cost
½x'Qx + q'x + ½u'Ru + r'u + u'Sx induces, after eliminating u, the
entry/exit cost kernel

    S(x, z) = ½ x'J x − η'x + quad(z − Ã x − b; C)

with Ã = A − B R⁻¹S, b = c − B R⁻¹r, C = B R⁻¹B' (singular — never
inverted), J = Q − S'R⁻¹S, η = −(q − S'R⁻¹r).  Composition
S_ij(x,z) = min_y S_i(x,y) + S_j(y,z) is closed under this 5-tuple:

    M   = (I + C_i J_j)⁻¹
    A'' = A_j M A_i
    b'' = A_j M (b_i + C_i η_j) + b_j
    C'' = A_j M C_i A_j' + C_j
    η'' = A_i' (I + J_j C_i)⁻¹ (η_j − J_j b_i) + η_i
    J'' = A_i' (I + J_j C_i)⁻¹ J_j A_i + J_i

and a reversed associative scan of stages k..N yields the cost-to-go
V_k(x) = ½ x'P_k x + p_k'x with P_k = J_{k:N}, p_k = −η_{k:N}.  Exactness
vs the sequential recursion is pinned in tests/test_riccati.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops import riccati as riccati_seq


class _Elem(NamedTuple):
    A: jnp.ndarray
    b: jnp.ndarray
    C: jnp.ndarray
    eta: jnp.ndarray
    J: jnp.ndarray


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Compose earlier element ei with later element ej (batched over the
    leading scan axis by associative_scan)."""
    nx = ei.A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(nx, dtype=ei.A.dtype), ei.A.shape)
    # solves instead of inverses; (I + C_i J_j) is nonsingular for convex
    # stage costs (C psd, J psd)
    M = jnp.linalg.solve(eye + ei.C @ ej.J, eye)
    Mt = jnp.linalg.solve(eye + ej.J @ ei.C, eye)
    AjM = ej.A @ M
    A = AjM @ ei.A
    b = (AjM @ (ei.b + (ei.C @ ej.eta[..., None])[..., 0])[..., None]
         )[..., 0] + ej.b
    C = AjM @ ei.C @ jnp.swapaxes(ej.A, -1, -2) + ej.C
    AiT = jnp.swapaxes(ei.A, -1, -2)
    rhs = ej.eta - (ej.J @ ei.b[..., None])[..., 0]
    eta = (AiT @ Mt @ rhs[..., None])[..., 0] + ei.eta
    J = AiT @ Mt @ ej.J @ ei.A + ei.J
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    return _Elem(A=A, b=b, C=C, eta=eta, J=J)


def cost_to_go_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term):
    """All cost-to-go pairs (P_k, p_k), k = 0..N, in O(log N) depth.

    Same arguments as `riccati.factorize`/`backward_vector` combined.
    Returns (P (N+1, nx, nx), p (N+1, nx)).
    """
    N, nx, nu = B.shape
    dtype = A.dtype

    Rinv_r = jnp.linalg.solve(Ruu, ru[..., None])[..., 0]      # (N, nu)
    Rinv_S = jnp.linalg.solve(Ruu, S)                          # (N, nu, nx)
    Rinv_Bt = jnp.linalg.solve(Ruu, jnp.swapaxes(B, -1, -2))   # (N, nu, nx)

    A_t = A - B @ Rinv_S
    b = c - (B @ Rinv_r[..., None])[..., 0]
    C = B @ Rinv_Bt
    J = Qxx - jnp.swapaxes(S, -1, -2) @ Rinv_S
    eta = -(qx - (jnp.swapaxes(S, -1, -2) @ Rinv_r[..., None])[..., 0])

    # terminal element: absorbs z-dependence (A = 0, C = 0)
    z_m = jnp.zeros((1, nx, nx), dtype)
    elems = _Elem(
        A=jnp.concatenate([A_t, z_m], axis=0),
        b=jnp.concatenate([b, jnp.zeros((1, nx), dtype)], axis=0),
        C=jnp.concatenate([C, z_m], axis=0),
        eta=jnp.concatenate([eta, -p_term[None]], axis=0),
        J=jnp.concatenate([J, P_term[None]], axis=0),
    )
    # reverse=True reverses the sequence before prefix-combining, so the
    # operator's LEFT operand is the LATER element — swap back to keep
    # _combine's (earlier, later) convention.
    suffix = jax.lax.associative_scan(lambda a, b: _combine(b, a), elems,
                                      reverse=True)
    return suffix.J, -suffix.eta


def solve_lq_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term, dx0):
    """Full equality-constrained LQ solve in O(log N) depth.

    Backward: associative-scan cost-to-go; per-stage gains are then local.
    Forward: the closed-loop rollout dx_{k+1} = (A+BK)dx + (B kff + c) is a
    composition of affine maps — also an associative scan.
    Matches `riccati.solve_lq` (tests/test_riccati.py).
    """
    N, nx, nu = B.shape
    P, p = cost_to_go_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term)
    P_next, p_next = P[1:], p[1:]

    Bt = jnp.swapaxes(B, -1, -2)
    Quu = Ruu + Bt @ P_next @ B
    Qux = S + Bt @ P_next @ A
    m = p_next + (P_next @ c[..., None])[..., 0]
    Qu = ru + (Bt @ m[..., None])[..., 0]
    K = -jnp.linalg.solve(Quu, Qux)
    kff = -jnp.linalg.solve(Quu, Qu[..., None])[..., 0]

    # forward pass as an associative scan of affine maps (M, v):
    # dx_{k+1} = M_k dx_k + v_k with M = A + B K, v = B kff + c
    M = A + B @ K
    v = (B @ kff[..., None])[..., 0] + c

    def comb(f, g):
        """apply g after f: x -> g.M (f.M x + f.v) + g.v."""
        Mf, vf = f
        Mg, vg = g
        return Mg @ Mf, (Mg @ vf[..., None])[..., 0] + vg

    Ms, vs = jax.lax.associative_scan(comb, (M, v))
    dx_tail = (Ms @ dx0[None, :, None])[..., 0] + vs    # dx_1..dx_N
    dx = jnp.concatenate([dx0[None], dx_tail], axis=0)
    du = (K @ dx[:-1][..., None])[..., 0] + kff
    return dx, du


def factors_pscan(A, B, Qxx, Ruu, S, P_term):
    """RiccatiFactors (P, K, Quu_chol) via the parallel scan — drop-in for
    `riccati.factorize` where only the quadratic terms matter."""
    N, nx, nu = B.shape
    zero_q = jnp.zeros((N, nx), A.dtype)
    zero_r = jnp.zeros((N, nu), A.dtype)
    zero_c = jnp.zeros((N, nx), A.dtype)
    P, _ = cost_to_go_pscan(A, B, zero_c, Qxx, zero_q, Ruu, zero_r, S,
                            P_term, jnp.zeros((nx,), A.dtype))
    P_next = P[1:]
    Bt = jnp.swapaxes(B, -1, -2)
    Quu = Ruu + Bt @ P_next @ B
    Qux = S + Bt @ P_next @ A
    K = -jnp.linalg.solve(Quu, Qux)
    chol = jax.vmap(lambda M: jnp.linalg.cholesky(M))(Quu)
    return riccati_seq.RiccatiFactors(P=P, K=K, Quu_chol=chol)
