"""Hopper kernel for the two Riccati sweeps of a condensed IPM iteration.

Each Mehrotra iteration on the block-2 condensed problem (M = N/2 stages,
13 states, 8 stacked inputs) runs two sweeps: `kkt_sweep_c2` (Riccati
factorization + affine backward pass + forward rollout) and
`corrector_sweep_c2` (vector backward pass on the stored factorization +
rollout).  The recursion is sequential over stages and independent per
lane.  Under XLA (`ops.sweeps`, the plain version and yardstick) every
stage is at least one launch and the cost-to-go round-trips through device
memory.  Here one launch covers a whole sweep:

  * the grid covers lane blocks only — one program owns `LANES` lanes;
  * the stages run as an in-kernel `fori_loop`, backward then forward;
  * a matrix is a (16, 16, LANES) tile: rows and columns padded 13 -> 16
    with zeros, so every shape is a power of two and padded entries stay
    exactly zero through the recursion (padded A/B/c rows and columns
    are zero, so they never reach a real entry);
  * small products are sums of outer products of rows loaded from
    memory, X @ Y = sum_k X[:, k] (x) Y[k, :], so no value is indexed
    inside registers.  Intermediates a later product reads by row (P,
    P A, P B, the Q-blocks) go through a per-program scratch region,
    which stays in L1/L2, with a barrier between writer and reader;
  * the 8 x 8 Cholesky and its triangular solves run per lane on (LANES,)
    rows, right-hand sides as whole 16-wide rows.

Gains (K, kff, L, Pc) are written to device memory, and the forward phase
of the same program re-reads them, so the horizon length costs no on-chip
storage.  The route is Pallas with `backend="triton"`; f32 only.

Operands: `stage_data` pads the per-solve constant stage matrices once
(Abar, Bbar, Qbar, and the condensed cross term and input block); the
per-call vectors are padded by the wrappers.  The gains stay in the
kernel's padded layout (they only travel from one sweep to the other);
dx and du come back in the caller's shapes.  Lanes: the wrappers pad B
up to a multiple of `LANES` (repeating the last lane, so padded lanes
solve a real problem) and slice the result.
"""

from __future__ import annotations

import functools as _ft

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from crazyflie_nmpc_tpu.ops.sweeps import NUC, NX, pk

NP = 16                          # state dimension padded to a power of two
NLC = NUC * (NUC + 1) // 2       # packed Cholesky entries of the 8 x 8 Quu

LANES = 16                       # lanes per program
NUM_WARPS = 4


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

def pad_lanes(x, lanes: int = LANES):
    """Pad the trailing (lane) axis up to a multiple of `lanes` by
    repeating the last lane; a no-op when it already divides."""
    extra = -x.shape[-1] % lanes
    if extra == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, extra)], mode="edge")


def _pad_rows(x, sizes):
    """Zero-pad the axes just before the lane axis to `sizes`."""
    k = len(sizes)
    pads = [(0, 0)] * (x.ndim - 1 - k) + [
        (0, n - d) for n, d in zip(sizes, x.shape[-1 - k:-1])] + [(0, 0)]
    return jnp.pad(x, pads)


def stage_data(Abar, Bbar, Qbar, S1T, R00):
    """Pad the constant stage data of one condensed solve for the kernel:
    (A (M,16,16,·), B (M,16,8,·), Q (M,16,16,·), S (M,8,16,·) = [S1T; 0],
    R (M,8,8,·) = [[R00, 0], [0, 0]]), lanes padded to `LANES`."""
    S = _pad_rows(S1T, (NUC, NP))
    R = _pad_rows(R00, (NUC, NUC))
    return tuple(pad_lanes(x) for x in (
        _pad_rows(Abar, (NP, NP)), _pad_rows(Bbar, (NP, NUC)),
        _pad_rows(Qbar, (NP, NP)), S, R))


def _vec(x, n=NP):
    return pad_lanes(_pad_rows(x, (n,)))


# ---------------------------------------------------------------------------
# in-kernel helpers
# ---------------------------------------------------------------------------

def _barrier(on):
    # a program's threads exchange rows through scratch memory; the
    # interpreter runs programs whole and has no barrier primitive
    if on:
        pltr.debug_barrier()


def _outer(col, row):
    """(n, L) x (m, L) -> (n, m, L): col[:, None] * row[None]."""
    return col[:, None, :] * row[None, :, :]


def _chol_solve_setup(Us, ruu_ref, s, ln):
    """Per-lane Cholesky of Quu = Us + diag(ruu) -> packed L, 1/diag."""
    L = [None] * NLC
    inv = [None] * NUC
    for j in range(NUC):
        v = Us[j, j, ln] + ruu_ref[s, j, ln]
        for t in range(j):
            v = v - L[pk(j, t, NUC)] * L[pk(j, t, NUC)]
        inv[j] = jax.lax.rsqrt(v)
        L[pk(j, j, NUC)] = v * inv[j]
        for i in range(j + 1, NUC):
            v = Us[i, j, ln]
            for t in range(j):
                v = v - L[pk(i, t, NUC)] * L[pk(j, t, NUC)]
            L[pk(i, j, NUC)] = v * inv[j]
    return L, inv


def _cho_solve(L, inv, y, row):
    """Solve (L L^T) x = y for 8 right-hand-side rows y[i] (each (L,) or
    (16, L)); row(v) broadcasts a per-lane scalar against a row."""
    z = [None] * NUC
    for i in range(NUC):
        v = y[i]
        for t in range(i):
            v = v - row(L[pk(i, t, NUC)]) * z[t]
        z[i] = v * row(inv[i])
    x = [None] * NUC
    for i in range(NUC - 1, -1, -1):
        v = z[i]
        for t in range(i + 1, NUC):
            v = v - row(L[pk(t, i, NUC)]) * x[t]
        x[i] = v * row(inv[i])
    return x


def _same(v):
    return v


def _bcast(v):
    return v[None, :]


def _forward(A_ref, B_ref, c_ref, K_ref, kff_ref, dx0_ref, dx_ref, du_ref,
             M, ln):
    """Rollout du = K dx + kff, dx' = A dx + B du + c over all stages."""
    def body(s, dx):
        du = (jnp.sum(K_ref[s, :, :, ln] * dx[None], axis=1)
              + kff_ref[s, :, ln])
        dx_ref[s, :, ln] = dx
        du_ref[s, :, ln] = du
        return (jnp.sum(A_ref[s, :, :, ln] * dx[None], axis=1)
                + jnp.sum(B_ref[s, :, :, ln] * du[None], axis=1)
                + c_ref[s, :, ln])

    dx_ref[M, :, ln] = jax.lax.fori_loop(0, M, body, dx0_ref[:, ln])


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _kkt_kernel(M, bl, barrier,
                A_ref, B_ref, Q_ref, S_ref, R_ref, c_ref, qx_ref, ruu_ref,
                ru_ref, pT_ref, pt_ref, dx0_ref,
                K_ref, kff_ref, L_ref, Pc_ref, dx_ref, du_ref,
                Ps, Ws, Vs, Xs, Us, us):
    ln = pl.ds(pl.multiple_of(pl.program_id(0) * bl, bl), bl)
    pT = pT_ref[:, ln]
    for k in range(NP):
        Ps[k, :, ln] = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, (NP, bl), 0) == k, pT, 0.0)

    def body(t, p):
        s = M - 1 - t
        _barrier(barrier)
        # P A, P B, P c with P's columns read (symmetrized) from scratch
        PA = PB = Pc = None
        for k in range(NX):
            col = 0.5 * (Ps[:, k, ln] + Ps[k, :, ln])
            a = _outer(col, A_ref[s, k, :, ln])
            b = _outer(col, B_ref[s, k, :, ln])
            v = col * c_ref[s, k, ln][None, :]
            PA = a if PA is None else PA + a
            PB = b if PB is None else PB + b
            Pc = v if Pc is None else Pc + v
        m = p + Pc
        Ws[:, :, ln] = PA
        Vs[:, :, ln] = PB
        _barrier(barrier)
        # A'PA, B'PA, B'PB as sums over rows k of A, B, PA, PB
        APA = BPA = BPB = None
        for k in range(NX):
            a, b = A_ref[s, k, :, ln], B_ref[s, k, :, ln]
            w, v = Ws[k, :, ln], Vs[k, :, ln]
            terms = (_outer(a, w), _outer(b, w), _outer(b, v))
            if APA is None:
                APA, BPA, BPB = terms
            else:
                APA, BPA, BPB = (APA + terms[0], BPA + terms[1],
                                 BPB + terms[2])
        At = A_ref[s, :, :, ln]
        Am = jnp.sum(At * m[:, None, :], axis=0)                 # A'm
        Bm = jnp.sum(B_ref[s, :, :, ln] * m[:, None, :], axis=0)  # B'm
        Xs[:, :, ln] = BPA + S_ref[s, :, :, ln]                  # Qux
        Us[:, :, ln] = BPB + R_ref[s, :, :, ln]                  # Quu - diag
        us[:, ln] = ru_ref[s, :, ln] + Bm                        # Qu
        _barrier(barrier)

        L, inv = _chol_solve_setup(Us, ruu_ref, s, ln)
        Qux = [Xs[i, :, ln] for i in range(NUC)]
        Qu = [us[i, ln] for i in range(NUC)]
        K = [-x for x in _cho_solve(L, inv, Qux, _bcast)]
        kff = [-x for x in _cho_solve(L, inv, Qu, _same)]
        for i in range(NUC):
            K_ref[s, i, :, ln] = K[i]
            kff_ref[s, i, ln] = kff[i]
        for i in range(NLC):
            L_ref[s, i, ln] = L[i]
        Pc_ref[s, :, ln] = Pc

        # P' = Q + A'PA + Qux'K, p' = qx + A'm + K'Qu
        P_new = Q_ref[s, :, :, ln] + APA
        p_new = qx_ref[s, :, ln] + Am
        for i in range(NUC):
            P_new = P_new + _outer(Qux[i], K[i])
            p_new = p_new + K[i] * Qu[i][None, :]
        Ps[:, :, ln] = P_new
        return p_new

    jax.lax.fori_loop(0, M, body, pt_ref[:, ln])
    _barrier(barrier)
    _forward(A_ref, B_ref, c_ref, K_ref, kff_ref, dx0_ref, dx_ref, du_ref,
             M, ln)


def _corrector_kernel(M, bl, barrier,
                      A_ref, B_ref, c_ref, qx_ref, ru_ref, K_ref, L_ref,
                      Pc_ref, pt_ref, dx0_ref,
                      dx_ref, du_ref, kff_ref, us):
    ln = pl.ds(pl.multiple_of(pl.program_id(0) * bl, bl), bl)

    def body(t, p):
        s = M - 1 - t
        m = p + Pc_ref[s, :, ln]
        _barrier(barrier)
        us[:, ln] = (ru_ref[s, :, ln]
                     + jnp.sum(B_ref[s, :, :, ln] * m[:, None, :], axis=0))
        _barrier(barrier)
        L = [L_ref[s, i, ln] for i in range(NLC)]
        inv = [1.0 / L[pk(i, i, NUC)] for i in range(NUC)]
        Qu = [us[i, ln] for i in range(NUC)]
        kff = _cho_solve(L, inv, Qu, _same)
        p_new = qx_ref[s, :, ln] + jnp.sum(
            A_ref[s, :, :, ln] * m[:, None, :], axis=0)
        for i in range(NUC):
            kff_ref[s, i, ln] = -kff[i]
            p_new = p_new + K_ref[s, i, :, ln] * Qu[i][None, :]
        return p_new

    jax.lax.fori_loop(0, M, body, pt_ref[:, ln])
    _barrier(barrier)
    _forward(A_ref, B_ref, c_ref, K_ref, kff_ref, dx0_ref, dx_ref, du_ref,
             M, ln)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _call(kernel, args, out_shapes, interpret):
    Bp = args[0].shape[-1]
    return pl.pallas_call(
        kernel,
        grid=(Bp // LANES,),
        out_shape=[jax.ShapeDtypeStruct(s + (Bp,), args[0].dtype)
                   for s in out_shapes],
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        backend="triton",
        interpret=interpret,
        name=kernel.func.__name__.strip("_"),
    )(*args)


def kkt_sweep_c2(data, cbar, qx, ruu_shift, ru, pT_diag, p_term, dx0,
                 interpret: bool = False):
    """Dense-cost Riccati factorization + forward rollout over the
    condensed horizon, one launch.  `data` = `stage_data(...)`; the rest
    as `ops.sweeps.kkt_sweep`.  Returns (K, kff, L, Pc) in the kernel's
    padded layout and dx (M+1,13,B), du (M,8,B)."""
    M, B = data[0].shape[0], cbar.shape[-1]
    K, kff, L, Pc, dx, du, *_ = _call(
        _ft.partial(_kkt_kernel, M, LANES, not interpret),
        data + (_vec(cbar), _vec(qx), pad_lanes(ruu_shift), pad_lanes(ru),
                _vec(pT_diag), _vec(p_term), _vec(dx0)),
        [(M, NUC, NP), (M, NUC), (M, NLC), (M, NP), (M + 1, NP), (M, NUC),
         (NP, NP), (NP, NP), (NP, NUC), (NUC, NP), (NUC, NUC), (NUC,)],
        interpret)
    return K, kff, L, Pc, dx[:, :NX, :B], du[..., :B]


def corrector_sweep_c2(data, cbar, qx, ru, K, L, Pc, p_term, dx0,
                       interpret: bool = False):
    """Vector backward pass + forward rollout on the stored condensed
    factorization (the padded K, L, Pc of `kkt_sweep_c2`), one launch ->
    (dx (M+1,13,B), du (M,8,B))."""
    A, Bm = data[0], data[1]
    M, B = A.shape[0], cbar.shape[-1]
    dx, du, *_ = _call(
        _ft.partial(_corrector_kernel, M, LANES, not interpret),
        (A, Bm, _vec(cbar), _vec(qx), pad_lanes(ru), K, L, Pc,
         _vec(p_term), _vec(dx0)),
        [(M + 1, NP), (M, NUC), (M, NUC), (NUC,)],
        interpret)
    return dx[:, :NX, :B], du[..., :B]
