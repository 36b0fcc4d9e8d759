"""Batch-last Riccati sweeps and block-2 condensing in plain JAX.

Layout: batch-LAST.  A matrix batch is shaped (..., n, m, B) and a vector
batch (..., n, B); every matrix element is a (B,) lane vector, so a small
matrix product is a short loop of broadcast FMAs that XLA fuses into a few
elementwise kernels.  There are no dot products anywhere in this module, so
no matmul-precision setting (TF32 on GPUs) can change its results.

Cost structure: the stage cost arrives either as a DIAGONAL (the reference
LLS cost, Qxx = diag(q), S = 0 — generate_c_code.py:62-129) or, on the
block-2 condensed problem, as a dense Q with a cross term S and a dense
input block R.  One stage body covers both.  The backward sweep emits
`Pc[k] = P_{k+1} c_k` (13 floats/stage) instead of the dense P_{k+1}: that
vector is all the Mehrotra corrector's second backward pass needs of P.

Sweeps (stage recursion as `lax.scan`, lanes independent):
  kkt_sweep:        Riccati factorization + affine pass + forward rollout
                    -> (K, kff, L, Pc, dx, du)
  corrector_sweep:  vector backward pass on a stored (K, L, Pc) + rollout
                    -> (dx, du)
Stage-parallel block-2 condensing:
  condense2:  N-stage diagonal-cost data -> M = N/2 dense-cost stages
  expand2:    recover the eliminated odd states from the condensed solution

This is the CPU path and the yardstick for the hand-written sweep kernel
(`ops.pallas.sweep_kernel`), which runs the same recursion on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NX = 13
NU = 4
NUC = 2 * NU                    # condensed (stacked) input dimension


# ---------------------------------------------------------------------------
# small-matrix algebra on (..., n, m, B) lane tiles
# ---------------------------------------------------------------------------

def mm(a, b):
    """a @ b: (..., n, k, B), (..., k, m, B) -> (..., n, m, B)."""
    c = a[..., :, 0:1, :] * b[..., 0:1, :, :]
    for i in range(1, a.shape[-2]):
        c = c + a[..., :, i:i + 1, :] * b[..., i:i + 1, :, :]
    return c


def mtm(a, b):
    """a^T b: (..., k, n, B), (..., k, m, B) -> (..., n, m, B)."""
    c = a[..., 0, :, None, :] * b[..., 0:1, :, :]
    for i in range(1, a.shape[-3]):
        c = c + a[..., i, :, None, :] * b[..., i:i + 1, :, :]
    return c


def mv(a, v):
    """a @ v: (..., n, k, B), (..., k, B) -> (..., n, B)."""
    c = a[..., :, 0, :] * v[..., 0:1, :]
    for i in range(1, a.shape[-2]):
        c = c + a[..., :, i, :] * v[..., i:i + 1, :]
    return c


def mtv(a, v):
    """a^T v: (..., k, n, B), (..., k, B) -> (..., n, B)."""
    c = a[..., 0, :, :] * v[..., 0:1, :]
    for i in range(1, a.shape[-3]):
        c = c + a[..., i, :, :] * v[..., i:i + 1, :]
    return c


def add_diag(M, d):
    """M (..., n, n, B) + diag(d) with d (..., n, B)."""
    n = M.shape[-2]
    eye = jnp.eye(n, dtype=M.dtype)[:, :, None]
    return M + eye * d[..., None, :, :]


def pk(i, j, n):
    """Packed index of L[i, j] (i >= j), column-major lower."""
    return j * n - j * (j - 1) // 2 + (i - j)


def chol(M):
    """Unrolled Cholesky of (n, n, B) -> packed lower (n(n+1)/2, B).

    rsqrt form: each column's sqrt + divide become one rsqrt + multiplies.
    """
    n = M.shape[0]
    L = [None] * (n * (n + 1) // 2)
    for j in range(n):
        s = M[j, j]
        for t in range(j):
            s = s - L[pk(j, t, n)] * L[pk(j, t, n)]
        inv = jax.lax.rsqrt(s)
        L[pk(j, j, n)] = s * inv
        for i in range(j + 1, n):
            s = M[i, j]
            for t in range(j):
                s = s - L[pk(i, t, n)] * L[pk(j, t, n)]
            L[pk(i, j, n)] = s * inv
    return jnp.stack(L)


def cho_solve(L, Y):
    """Solve (L L^T) X = Y, packed L (n(n+1)/2, B), Y (n, ..., B)."""
    n = Y.shape[0]
    inv = [1.0 / L[pk(i, i, n)] for i in range(n)]
    ext = (None,) * (Y.ndim - 2)
    lij = lambda i, j: L[pk(i, j, n)][ext]
    z = [None] * n
    for i in range(n):
        s = Y[i]
        for t in range(i):
            s = s - lij(i, t) * z[t]
        z[i] = s * inv[i][ext]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = z[i]
        for t in range(i + 1, n):
            s = s - lij(t, i) * x[t]
        x[i] = s * inv[i][ext]
    return jnp.stack(x)


# ---------------------------------------------------------------------------
# Riccati stage bodies
# ---------------------------------------------------------------------------

def factor_stage(P, p, A, Bm, c, Q, S, R, qx, ruu, ru):
    """One backward Riccati stage.

    Q is the state cost as a dense (n, n, B) block or a (n, B) diagonal;
    S (m, n, B) the cross term and R (m, m, B) the dense input block, or
    None for zero; ruu (m, B) the input diagonal incl. the IPM barrier
    shift.  Returns (P', p', K, kff, L, Pc).
    """
    PA = mm(P, A)
    PB = mm(P, Bm)
    Pc = mv(P, c)
    m = p + Pc
    BtPB = mtm(Bm, PB)
    Quu = add_diag(BtPB if R is None else BtPB + R, ruu)
    Qux = mtm(Bm, PA) if S is None else S + mtm(Bm, PA)
    Qu = ru + mtv(Bm, m)

    L = chol(Quu)
    K = -cho_solve(L, Qux)
    kff = -cho_solve(L, Qu)

    APA = mtm(A, PA) + mtm(Qux, K)
    P_new = add_diag(APA, Q) if Q.ndim == 2 else Q + APA
    P_new = 0.5 * (P_new + jnp.swapaxes(P_new, 0, 1))
    p_new = qx + mtv(A, m) + mtv(K, Qu)
    return P_new, p_new, K, kff, L, Pc


def vector_stage(p, A, Bm, qx, ru, K, L, Pc):
    """One backward vector pass stage on a stored factorization."""
    m = p + Pc
    Qu = ru + mtv(Bm, m)
    kff = -cho_solve(L, Qu)
    return qx + mtv(A, m) + mtv(K, Qu), kff


def _rollout(A, Bm, c, K, kff, dx0):
    def step(dx, xs):
        A_k, B_k, c_k, K_k, kff_k = xs
        du = mv(K_k, dx) + kff_k
        return mv(A_k, dx) + mv(B_k, du) + c_k, (dx, du)

    dxT, (dxs, dus) = jax.lax.scan(step, dx0, (A, Bm, c, K, kff))
    return jnp.concatenate([dxs, dxT[None]], axis=0), dus


def kkt_sweep(A, Bm, c, Q, S, R, qx, ruu, ru, pT, p_term, dx0):
    """Riccati factorization + affine backward pass + forward rollout.

    Stage-stacked batch-last inputs: A (N,n,n,B), Bm (N,n,m,B), c (N,n,B),
    Q (N,n,n,B) dense or (N,n,B) diagonal, S (N,m,n,B) or None, R
    (N,m,m,B) or None, qx (N,n,B), ruu/ru (N,m,B); terminal cost diagonal
    pT (n,B), gradient p_term (n,B); initial state deviation dx0 (n,B).
    Returns (K (N,m,n,B), kff (N,m,B), L (N,m(m+1)/2,B), Pc (N,n,B),
    dx (N+1,n,B), du (N,m,B)).
    """
    n = A.shape[1]
    P0 = jnp.eye(n, dtype=pT.dtype)[:, :, None] * pT[None]

    def step(carry, xs):
        P, p = carry
        P, p, K, kff, L, Pc = factor_stage(P, p, *xs)
        return (P, p), (K, kff, L, Pc)

    _, (K, kff, L, Pc) = jax.lax.scan(
        step, (P0, p_term), (A, Bm, c, Q, S, R, qx, ruu, ru), reverse=True)
    dx, du = _rollout(A, Bm, c, K, kff, dx0)
    return K, kff, L, Pc, dx, du


def corrector_sweep(A, Bm, c, qx, ru, K, L, Pc, p_term, dx0):
    """Vector backward pass with the stored (K, L, Pc) of `kkt_sweep` and
    a new right-hand side, then the forward rollout -> (dx, du)."""
    def step(p, xs):
        return vector_stage(p, *xs)

    _, kff = jax.lax.scan(step, p_term, (A, Bm, qx, ru, K, L, Pc),
                          reverse=True)
    return _rollout(A, Bm, c, K, kff, dx0)


# ---------------------------------------------------------------------------
# block-2 condensing (stage pairs are independent)
# ---------------------------------------------------------------------------

def condense_pair(A0, A1, B0, B1, c0, c1, q0, q1, qx0, qx1, ru0, ru1):
    """Eliminate the interior state x1 = A0 x + B0 u0 + c0 of one stage
    pair through its diagonal stage cost q1 (exact; cf. ops/condensing.py).
    Works on single stages (n, ·, B) and on stage-stacked (M, n, ·, B)."""
    qA = q1[..., :, None, :] * A0                     # diag(q1) A0
    qB = q1[..., :, None, :] * B0
    h = q1 * c0 + qx1
    return dict(
        Abar=mm(A1, A0),
        Bbar=jnp.concatenate([mm(A1, B0), B1], axis=-2),
        cbar=mv(A1, c0) + c1,
        Qbar=add_diag(mtm(A0, qA), q0),
        S1T=mtm(B0, qA),                              # (4,13) = B0' q1 A0
        R00=mtm(B0, qB),
        qbar=qx0 + mtv(A0, h),
        rbar=jnp.concatenate([ru0 + mtv(B0, h), ru1], axis=-2),
    )


def condense2(A, Bm, c, qxx, qx, ru):
    """Condense stage pairs: N-stage diagonal-cost QP data -> M = N/2
    dense-cost stages.  All arrays batch-last.

    Returns dict with Abar (M,13,13,·), Bbar (M,13,8,·), cbar (M,13,·),
    Qbar (M,13,13,·), S1T (M,4,13,·) [S̄^T's nonzero half], R00 (M,4,4,·),
    qbar (M,13,·), rbar (M,8,·).
    """
    if c.shape[0] % 2 != 0:
        raise ValueError("block-2 condensing needs even N")
    e, o = slice(0, None, 2), slice(1, None, 2)
    return condense_pair(A[e], A[o], Bm[e], Bm[o], c[e], c[o], qxx[e],
                         qxx[o], qx[e], qx[o], ru[e], ru[o])


def expand2(A_even, B_even, c, dx_even, du0):
    """Recover the eliminated odd states through their dynamics row:
    dx_odd[k] = A[2k] dx_even[k] + B[2k] du0[k] + c[2k].

    A_even/B_even are the first-of-pair stage Jacobians (M, ...); c the
    full N-stage defect; dx_even (M,13,·) and du0 (M,4,·) the condensed
    solution's states and first-of-pair inputs."""
    return mv(A_even, dx_even) + mv(B_even, du0) + c[0::2]


def split_condensed_cost(S1T, R00):
    """The condensed cross term S̄ = [S1T; 0] (8,13) and dense input block
    R̄ = [[R00, 0], [0, 0]] (8,8), stage-stacked."""
    zS = jnp.zeros_like(S1T)
    S = jnp.concatenate([S1T, zS], axis=-3)
    zR = jnp.zeros_like(R00)
    R = jnp.concatenate([jnp.concatenate([R00, zR], axis=-2),
                         jnp.concatenate([zR, zR], axis=-2)], axis=-3)
    return S, R
