"""Batch-last interior-point solver for many independent QPs.

Same algorithm as `ops.ipm` (Mehrotra predictor-corrector with exact
(1-alpha) affine-residual tracking — see that module for the math), but
organized for throughput over a batch:

  * all problem data is batch-LAST ((N, n, m, B)); every matrix entry is
    a (B,) lane vector,
  * the two Riccati sweeps per iteration (factorization + rollout, then
    the corrector) run either as `lax.scan` recursions (`ops.sweeps`) or,
    on the block-2 condensed problem on a GPU, as one hand-written kernel
    launch each (`ops.pallas.sweep_kernel`); `ops.backend` decides,
  * per-problem scalars (mu, step lengths) are (B,) lane vectors,
  * the elementwise barrier algebra between sweeps stays in XLA, which
    fuses it into a handful of kernels.

`solve_batched` consumes a batch-last QP dict; `from_qpdata` converts a
vmapped (batch-first) QPData.  Tested for agreement with `ops.ipm` in
tests/test_pallas_kernels.py.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops import sweeps
from crazyflie_nmpc_tpu.ops.backend import resolve_sweep
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu.ops.qp import QPData


class BatchSolution(NamedTuple):
    dx: Any      # (N+1, nx, B)
    du: Any      # (N, nu, B)
    lam_l: Any   # (N, nu, B)
    lam_u: Any   # (N, nu, B)
    stats: Any   # dict with (B,) entries


def from_qpdata(qp: QPData) -> dict:
    """Vmapped (batch-first) QPData -> batch-last array dict.

    The batched solver exploits the reference cost structure: Qxx/Ruu/P
    diagonal, S = 0 (LLS cost with selector Vx/Vu, generate_c_code.py:
    86-107).  Only the diagonals are extracted — callers with genuinely
    dense cost blocks must use `ops.ipm` instead.
    """
    bl = lambda x: jnp.moveaxis(x, 0, -1)
    diag = lambda x: jnp.diagonal(x, axis1=-2, axis2=-1)
    return dict(A=bl(qp.A), B=bl(qp.B), c=bl(qp.c),
                qxx=bl(diag(qp.Qxx)), qx=bl(qp.qx),
                ruu=bl(diag(qp.Ruu)), ru=bl(qp.ru),
                pT=bl(diag(qp.P)), p=bl(qp.p), lb=bl(qp.lb), ub=bl(qp.ub),
                dx0=bl(qp.dx0))


def _max_step_lane(v, dv, tau):
    """Per-lane fraction-to-boundary over the (N, nu) axes -> (B,)."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, tau * jnp.min(ratio, axis=(0, 1)))


def solve_batched(qp: dict, config: IPMConfig = IPMConfig(),
                  lam0_l=None, lam0_u=None, condense: int = 1,
                  sweep: str | None = None) -> BatchSolution:
    """Solve a batch of box-constrained multistage QPs (batch-last layout,
    diagonal cost — see `from_qpdata`).

    All (B,) problems run in lockstep with per-lane step lengths; infinite
    bounds are masked exactly as in `ops.ipm`.

    condense=2 runs the IPM on the block-2 PARTIALLY CONDENSED problem
    (the reference's own QP-backend structure, PARTIAL_CONDENSING_HPIPM,
    generate_c_code.py:140): stage pairs are condensed into M = N/2 dense
    stages with stacked 8-dim inputs (exact reparametrization — bounds ride
    the unchanged inputs), halving the sequential Riccati depth.  Requires
    even N.

    sweep: how the condensed Riccati sweeps run — "kernel" (the GPU sweep
    kernel), "plain" (`lax.scan`) or "interpret" (the kernel in the Pallas
    interpreter, for CPU tests); None lets `ops.backend.sweep_backend`
    decide from the platform.  condense=1 always runs the plain sweeps.

    Per-lane adaptive escalation (config.escalate_iters > 0 AND
    escalate_capacity > 0): the worst `escalate_capacity` lanes by final
    complementarity mu that exceed `escalate_mu_tol` are gathered into a
    compact sub-batch, re-solved from scratch with `escalate_iters` plain
    Mehrotra iterations, and scattered back.  Static shapes throughout
    (top_k with a fixed capacity); the whole escalation is guarded by
    lax.cond so converged batches pay nothing.  Cost on hard ticks
    ~ (capacity/B) x (escalate_iters/iters + fixed); accuracy: the
    iteration-starved saturating lanes converge to the exact active-set
    solution (tests/test_certification.py).  stats gains `escalated`
    (number of re-solved lanes).
    """
    sweep = resolve_sweep(sweep)
    sol = _solve_core(qp, config, lam0_l, lam0_u, condense, sweep)
    cap = config.escalate_capacity
    if config.escalate_iters <= 0 or cap <= 0:
        return sol
    B = qp["c"].shape[-1]
    cap = min(cap, B)
    esc_cfg = IPMConfig(
        iters=config.escalate_iters, tau=config.tau, reg=config.reg,
        s_min_init=config.s_min_init, mu0_init=config.mu0_init)

    score = sol.stats["mu"]
    bad = score > config.escalate_mu_tol
    masked = jnp.where(bad, score, -jnp.inf)
    _, idx = jax.lax.top_k(masked, cap)          # distinct lane indices
    valid = bad[idx]                              # (cap,)

    def scat(full, sub):
        upd = jnp.where(valid, sub, full[..., idx])
        return full.at[..., idx].set(upd)

    def escalate(_):
        sub_qp = {k: v[..., idx] for k, v in qp.items()}
        sub = _solve_core(sub_qp, esc_cfg, None, None, condense, sweep)
        stats = dict(sol.stats)
        for k in ("mu", "res_stat", "res_eq"):
            stats[k] = scat(stats[k], sub.stats[k])
        stats["escalated"] = jnp.sum(valid.astype(jnp.int32),
                                     dtype=jnp.int32)
        return BatchSolution(dx=scat(sol.dx, sub.dx),
                             du=scat(sol.du, sub.du),
                             lam_l=scat(sol.lam_l, sub.lam_l),
                             lam_u=scat(sol.lam_u, sub.lam_u),
                             stats=stats)

    def keep(_):
        stats = dict(sol.stats)
        stats["escalated"] = jnp.int32(0)
        return BatchSolution(dx=sol.dx, du=sol.du, lam_l=sol.lam_l,
                             lam_u=sol.lam_u, stats=stats)

    return jax.lax.cond(jnp.any(bad), escalate, keep, None)


def _solve_core(qp: dict, config: IPMConfig, lam0_l, lam0_u,
                condense: int, sweep: str) -> BatchSolution:
    # precondensed input (rti_step_batched's prep_condense2 path): the
    # condensed arrays arrive under "c2*" keys and the full-horizon A/B
    # were never materialized — A/B/qxx/qx/ru are absent, Ae/Be carry the
    # even-stage expansion data
    precond = "c2Abar" in qp
    A, Bm = qp.get("A"), qp.get("B")
    c = qp["c"]
    qxx, qx = qp.get("qxx"), qp.get("qx")
    ruu, ru = qp["ruu"], qp.get("ru")
    pT_diag, p_T = qp["pT"], qp["p"]
    N, nu, B = ruu.shape
    nx = c.shape[1]
    dtype = c.dtype

    if precond and condense != 2:
        raise ValueError("precondensed (c2*) QP data requires condense=2")
    cond2 = condense == 2
    if cond2:
        M = N // 2
        if precond:
            cnd = {k[2:]: qp[k] for k in
                   ("c2Abar", "c2Bbar", "c2cbar", "c2Qbar", "c2S1T",
                    "c2R00", "c2qbar", "c2rbar")}
            exp_A, exp_B = qp["c2Ae"], qp["c2Be"]
        else:
            cnd = sweeps.condense2(A, Bm, c, qxx, qx, ru)
            exp_A, exp_B = A[0::2], Bm[0::2]
        # bounds / slacks / duals are per ORIGINAL input; stage-major
        # layout makes the condensed stacking a pure reshape
        nuc = 2 * nu
        resh = lambda z: z.reshape(M, nuc, B)
        qp = dict(qp)
        qp["lb"], qp["ub"] = resh(qp["lb"]), resh(qp["ub"])
        if lam0_l is not None:
            lam0_l, lam0_u = resh(lam0_l), resh(lam0_u)
        N_orig, nu_orig = N, nu
        c_orig = c
        N, nu = M, nuc
        ru = cnd["rbar"]
        qx = cnd["qbar"]
        c = cnd["cbar"]
        ruu = resh(ruu)
        Abar, Bbar, Qbar = cnd["Abar"], cnd["Bbar"], cnd["Qbar"]
        if sweep == "plain":
            S, R = sweeps.split_condensed_cost(cnd["S1T"], cnd["R00"])

            def kkt(c_, qx_, ruu_, ru_, pt_, dx0_):
                return sweeps.kkt_sweep(Abar, Bbar, c_, Qbar, S, R, qx_,
                                        ruu_, ru_, pT_diag, pt_, dx0_)

            def corr(c_, qx_, ru_, K, L, Pc, pt_, dx0_):
                return sweeps.corrector_sweep(Abar, Bbar, c_, qx_, ru_, K,
                                              L, Pc, pt_, dx0_)
        else:
            from crazyflie_nmpc_tpu.ops.pallas import sweep_kernel as sk

            interp = sweep == "interpret"
            # constant over the solve: padded for the kernel once
            data = sk.stage_data(Abar, Bbar, Qbar, cnd["S1T"], cnd["R00"])

            def kkt(c_, qx_, ruu_, ru_, pt_, dx0_):
                return sk.kkt_sweep_c2(data, c_, qx_, ruu_, ru_, pT_diag,
                                       pt_, dx0_, interpret=interp)

            def corr(c_, qx_, ru_, K, L, Pc, pt_, dx0_):
                return sk.corrector_sweep_c2(data, c_, qx_, ru_, K, L, Pc,
                                             pt_, dx0_, interpret=interp)
    else:
        def kkt(c_, qx_, ruu_, ru_, pt_, dx0_):
            return sweeps.kkt_sweep(A, Bm, c_, qxx, None, None, qx_, ruu_,
                                    ru_, pT_diag, pt_, dx0_)

        def corr(c_, qx_, ru_, K, L, Pc, pt_, dx0_):
            return sweeps.corrector_sweep(A, Bm, c_, qx_, ru_, K, L, Pc,
                                          pt_, dx0_)

    finite_l = jnp.isfinite(qp["lb"])
    finite_u = jnp.isfinite(qp["ub"])
    lb = jnp.where(finite_l, qp["lb"], 0.0)
    ub = jnp.where(finite_u, qp["ub"], 0.0)
    n_ineq = jnp.maximum(
        jnp.sum(finite_l, axis=(0, 1)) + jnp.sum(finite_u, axis=(0, 1)), 1)
    has_ineq = (jnp.sum(finite_l, axis=(0, 1))
                + jnp.sum(finite_u, axis=(0, 1))) > 0

    # --- initial point (cf. ipm.init_state)
    z_du = jnp.zeros((N, nu, B), dtype)
    z_dx = jnp.zeros((N + 1, nx, B), dtype)
    s_l = jnp.where(finite_l, jnp.maximum(-lb, config.s_min_init), 1.0)
    s_u = jnp.where(finite_u, jnp.maximum(ub, config.s_min_init), 1.0)
    mu0 = jnp.asarray(config.mu0_init, dtype)
    lam_l = jnp.where(finite_l, mu0 / s_l, 0.0)
    lam_u = jnp.where(finite_u, mu0 / s_u, 0.0)
    # warm-started bound duals (cf. ipm.init_state): clipped interior
    if lam0_l is not None:
        lam_l = jnp.where(finite_l, jnp.maximum(lam0_l, 1e-4), 0.0)
    if lam0_u is not None:
        lam_u = jnp.where(finite_u, jnp.maximum(lam0_u, 1e-4), 0.0)

    r1x = jnp.concatenate([qx, p_T[None]], axis=0)        # (N+1, nx, B)
    r1u = ru - lam_l + lam_u
    r2 = jnp.concatenate([-qp["dx0"][None], -c], axis=0)  # (N+1, nx, B)
    r3 = jnp.where(finite_l, -lb - s_l, 0.0)
    r4 = jnp.where(finite_u, ub - s_u, 0.0)

    mu_floor = 100.0 * jnp.asarray(jnp.finfo(dtype).eps, dtype) ** 2
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def iteration(carry, _):
        (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry

        mu = (jnp.sum(lam_l * s_l * finite_l, axis=(0, 1))
              + jnp.sum(lam_u * s_u * finite_u, axis=(0, 1))) / n_ineq
        sig_l = jnp.where(finite_l, lam_l / s_l, 0.0)
        sig_u = jnp.where(finite_u, lam_u / s_u, 0.0)
        ruu_shift = ruu + sig_l + sig_u                   # (N, nu, B) diag

        r5l = lam_l * s_l
        r5u = lam_u * s_u
        rt1u = (r1u + jnp.where(finite_l, (r5l + lam_l * r3) / s_l, 0.0)
                - jnp.where(finite_u, (r5u + lam_u * r4) / s_u, 0.0))

        # ---- predictor: factorization + affine backward + forward rollout
        K, kff_a, L, Pc, ddx_a, ddu_a = kkt(
            -r2[1:], r1x[:-1], ruu_shift, rt1u, r1x[-1], -r2[0])

        ds_l_a = jnp.where(finite_l, ddu_a + r3, 0.0)
        ds_u_a = jnp.where(finite_u, r4 - ddu_a, 0.0)
        dlam_l_a = jnp.where(finite_l, -(r5l + lam_l * ds_l_a) / s_l, 0.0)
        dlam_u_a = jnp.where(finite_u, -(r5u + lam_u * ds_u_a) / s_u, 0.0)

        one_l = jnp.where(finite_l, s_l, 1.0)
        one_u = jnp.where(finite_u, s_u, 1.0)
        alpha_aff = jnp.minimum(
            jnp.minimum(_max_step_lane(one_l, ds_l_a, 1.0),
                        _max_step_lane(one_u, ds_u_a, 1.0)),
            jnp.minimum(
                _max_step_lane(jnp.where(finite_l, lam_l, 1.0), dlam_l_a,
                               1.0),
                _max_step_lane(jnp.where(finite_u, lam_u, 1.0), dlam_u_a,
                               1.0)))
        mu_aff = ((jnp.sum((lam_l + alpha_aff * dlam_l_a)
                           * (s_l + alpha_aff * ds_l_a) * finite_l,
                           axis=(0, 1))
                   + jnp.sum((lam_u + alpha_aff * dlam_u_a)
                             * (s_u + alpha_aff * ds_u_a) * finite_u,
                             axis=(0, 1))) / n_ineq)
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, tiny)) ** 3, 0.0, 1.0)

        # ---- corrector: reuse factorization, new RHS
        r5l_c = r5l - sigma * mu + ds_l_a * dlam_l_a
        r5u_c = r5u - sigma * mu + ds_u_a * dlam_u_a
        rt1u_c = (r1u + jnp.where(finite_l, (r5l_c + lam_l * r3) / s_l, 0.0)
                  - jnp.where(finite_u, (r5u_c + lam_u * r4) / s_u, 0.0))
        ddx, ddu = corr(-r2[1:], r1x[:-1], rt1u_c, K, L, Pc, r1x[-1],
                        -r2[0])

        ds_l = jnp.where(finite_l, ddu + r3, 0.0)
        ds_u = jnp.where(finite_u, r4 - ddu, 0.0)
        dlam_l = jnp.where(finite_l, -(r5l_c + lam_l * ds_l) / s_l, 0.0)
        dlam_u = jnp.where(finite_u, -(r5u_c + lam_u * ds_u) / s_u, 0.0)

        alpha = jnp.minimum(
            jnp.minimum(_max_step_lane(one_l, ds_l, config.tau),
                        _max_step_lane(one_u, ds_u, config.tau)),
            jnp.minimum(
                _max_step_lane(jnp.where(finite_l, lam_l, 1.0), dlam_l,
                               config.tau),
                _max_step_lane(jnp.where(finite_u, lam_u, 1.0), dlam_u,
                               config.tau)))

        # ---- Gondzio multiple centrality correctors (see ops.ipm.iterate
        # for the math and the accuracy/cost trade): one
        # extra corrector sweep each on the SAME factorization, RHS = pure
        # complementarity outlier correction, accepted per lane only where
        # the step lengthens.
        for _ in range(config.gondzio_correctors):
            mu_t = sigma * mu                                   # (B,)
            a_hat = jnp.minimum(alpha + 0.1, 1.0)
            v_l = (s_l + a_hat * ds_l) * (lam_l + a_hat * dlam_l)
            v_u = (s_u + a_hat * ds_u) * (lam_u + a_hat * dlam_u)
            t_l = jnp.where(finite_l,
                            jnp.clip(v_l, 0.1 * mu_t, 10.0 * mu_t) - v_l,
                            0.0)
            t_u = jnp.where(finite_u,
                            jnp.clip(v_u, 0.1 * mu_t, 10.0 * mu_t) - v_u,
                            0.0)
            rt1u_g = (jnp.where(finite_l, -t_l / s_l, 0.0)
                      + jnp.where(finite_u, t_u / s_u, 0.0))
            z_c = jnp.zeros_like(r2[1:])
            z_qx = jnp.zeros_like(r1x[:-1])
            z_pt = jnp.zeros_like(r1x[-1])
            z_dx0 = jnp.zeros_like(r2[0])
            # the stored Pc = P_{k+1} c_k bakes the ORIGINAL dynamics
            # residual into the backward vector pass; the pure
            # complementarity solve has zero dynamics residual, so Pc
            # must be zeroed here (K and L stay — they are factorization
            # state, independent of the RHS)
            z_Pc = jnp.zeros_like(Pc)
            ddx_g, ddu_g = corr(z_c, z_qx, rt1u_g, K, L, z_Pc, z_pt,
                                z_dx0)
            ds_l_g = jnp.where(finite_l, ddu_g, 0.0)
            ds_u_g = jnp.where(finite_u, -ddu_g, 0.0)
            dlam_l_g = jnp.where(finite_l, (t_l - lam_l * ds_l_g) / s_l,
                                 0.0)
            dlam_u_g = jnp.where(finite_u, (t_u - lam_u * ds_u_g) / s_u,
                                 0.0)
            ds_l2, ds_u2 = ds_l + ds_l_g, ds_u + ds_u_g
            dlam_l2, dlam_u2 = dlam_l + dlam_l_g, dlam_u + dlam_u_g
            alpha2 = jnp.minimum(
                jnp.minimum(_max_step_lane(one_l, ds_l2, config.tau),
                            _max_step_lane(one_u, ds_u2, config.tau)),
                jnp.minimum(
                    _max_step_lane(jnp.where(finite_l, lam_l, 1.0),
                                   dlam_l2, config.tau),
                    _max_step_lane(jnp.where(finite_u, lam_u, 1.0),
                                   dlam_u2, config.tau)))
            keep = alpha2 > alpha                                # (B,)
            pick = lambda new, old: jnp.where(keep, new, old)
            ddx = pick(ddx + ddx_g, ddx)
            ddu = pick(ddu + ddu_g, ddu)
            ds_l, ds_u = pick(ds_l2, ds_l), pick(ds_u2, ds_u)
            dlam_l, dlam_u = pick(dlam_l2, dlam_l), pick(dlam_u2, dlam_u)
            alpha = jnp.maximum(alpha, alpha2)

        alpha = jnp.where(has_ineq & (mu <= mu_floor), 0.0, alpha)

        z_dx = z_dx + alpha * ddx
        z_du = z_du + alpha * ddu
        s_l = jnp.where(finite_l, s_l + alpha * ds_l, 1.0)
        s_u = jnp.where(finite_u, s_u + alpha * ds_u, 1.0)
        lam_l = jnp.where(finite_l, lam_l + alpha * dlam_l, 0.0)
        lam_u = jnp.where(finite_u, lam_u + alpha * dlam_u, 0.0)

        shrink = 1.0 - alpha
        carry = (z_dx, z_du, s_l, s_u, lam_l, lam_u,
                 shrink * r1x, shrink * r1u, shrink * r2,
                 shrink * r3, shrink * r4)
        return carry, (alpha, mu)

    carry0 = (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4)
    carry, (alphas, mus) = jax.lax.scan(iteration, carry0, None,
                                        length=config.iters)
    (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry

    mu_final = (jnp.sum(lam_l * s_l * finite_l, axis=(0, 1))
                + jnp.sum(lam_u * s_u * finite_u, axis=(0, 1))) / n_ineq
    stats = dict(
        mu=mu_final,
        res_stat=jnp.maximum(jnp.max(jnp.abs(r1x), axis=(0, 1)),
                             jnp.max(jnp.abs(r1u), axis=(0, 1))),
        res_eq=jnp.max(jnp.abs(r2), axis=(0, 1)),
    )
    if cond2:
        # expand: interior states were eliminated exactly through their
        # dynamics row; recover them once (not per iteration)
        du_pairs = z_du                                  # (M, 8, B)
        dx_even = z_dx[:-1]                              # (M, 13, B)
        dx_odd = sweeps.expand2(exp_A, exp_B, c_orig, dx_even,
                                du_pairs[:, :nu_orig])
        dx_full = jnp.concatenate([
            jnp.stack([dx_even, dx_odd], axis=1).reshape(
                N_orig, dx_even.shape[1], B),
            z_dx[-1:]], axis=0)                          # (N_orig+1, nx, B)
        return BatchSolution(
            dx=dx_full,
            du=du_pairs.reshape(N_orig, nu_orig, B),
            lam_l=lam_l.reshape(N_orig, nu_orig, B),
            lam_u=lam_u.reshape(N_orig, nu_orig, B),
            stats=stats)

    return BatchSolution(dx=z_dx, du=z_du, lam_l=lam_l, lam_u=lam_u,
                        stats=stats)
