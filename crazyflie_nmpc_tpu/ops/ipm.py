"""Primal-dual interior-point method for box-constrained multistage QPs.

TPU-native re-design of the reference's QP backend (HPIPM partial-condensing
interior point on BLASFEO, generate_c_code.py:140, SURVEY.md section 2.3).
Design choices driven by XLA's compilation model:

  * Fixed iteration count (`lax.fori_loop`-style scan, static shapes) — HPIPM
    iterates until tolerance; under jit we run a fixed predictor-corrector
    schedule and *report* the achieved residuals (SURVEY.md section 7, hard
    part iii).
  * Mehrotra predictor-corrector sharing one Riccati factorization per
    iteration (two backward vector passes, one matrix factorization).
  * Residual tracking without equality duals: for a QP, every affine KKT
    residual contracts exactly by (1 - alpha) along a Newton step, so the
    stationarity/feasibility residual *vectors* are carried and rescaled
    instead of re-evaluated — no costate bookkeeping, fewer matmuls.
  * Everything is `vmap`-batchable: one IPM instance per scenario/drone, with
    per-element step lengths and barrier parameters.

KKT system (P = selector of du; s_l, s_u slack, lam_l, lam_u >= 0):
    r1   = H z + g + E'nu - P'lam_l + P'lam_u        (stationarity)
    r2   = E z - e                                    (dynamics + x0)
    r3   = P z - lb - s_l                             (lower bound)
    r4   = ub - P z - s_u                             (upper bound)
    r5_l = Lam_l s_l - sigma mu,  r5_u = Lam_u s_u - sigma mu

Eliminating (ds, dlam) yields an LQ problem with input-Hessian shift
Sigma = lam_l/s_l + lam_u/s_u, solved by `ops.riccati`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops import riccati
from crazyflie_nmpc_tpu.ops.backend import highest_precision
from crazyflie_nmpc_tpu.ops.qp import QPData


class IPMSolution(NamedTuple):
    dx: Any        # (N+1, nx) primal state deviations
    du: Any        # (N, nu)   primal input deviations
    lam_l: Any     # (N, nu)   lower-bound duals
    lam_u: Any     # (N, nu)   upper-bound duals
    stats: Any     # dict of convergence diagnostics


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Static solver knobs (pytree with meta fields only)."""

    iters: int = dataclasses.field(default=12, metadata=dict(static=True))
    tau: float = dataclasses.field(default=0.995, metadata=dict(static=True))
    reg: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    s_min_init: float = dataclasses.field(default=1e-2,
                                          metadata=dict(static=True))
    # initial complementarity target: duals start at lam = mu0_init / s, so
    # the barrier parameter begins at mu0_init instead of 1.  With the warm
    # primal iterate RTI carries (slacks already near their solution values),
    # a centered start at mu0 < 1 removes the first ~2 Mehrotra iterations
    # spent walking mu down from 1 — the stable form of warm-starting (it
    # never lets products collapse the way raw dual carryover does; cf.
    # init_state note).  1.0 reproduces the classic cold start.
    mu0_init: float = dataclasses.field(default=1.0,
                                        metadata=dict(static=True))
    # Gondzio multiple centrality correctors (Gondzio 1996): after the
    # Mehrotra corrector, run up to this many extra backsolves on the SAME
    # factorization, each targeting only the complementarity products that
    # fall outside [0.1, 10] x (sigma mu) at an enlarged trial step.  A
    # corrector is accepted per problem only if it lengthens the step.
    # Costs one corrector-sweep each; raises centrality per factorization
    # (HPIPM/acados have no analog — this is a beyond-parity knob).
    gondzio_correctors: int = dataclasses.field(default=0,
                                                metadata=dict(static=True))
    # Per-lane adaptive escalation (the saturation-accuracy fix): after the
    # fixed-iteration solve, problems whose final complementarity mu
    # exceeds `escalate_mu_tol` are RE-SOLVED from scratch with
    # `escalate_iters` iterations (plain Mehrotra).  Measured on the
    # saturating hover transient: the default 8-iteration budget leaves
    # kRPM-scale u error only on active-set-discovery ticks, where mu
    # stalls >= 1e-8; a 16-iteration re-solve converges those to machine
    # precision (certified vs the dense active-set oracle,
    # tests/test_certification.py).  escalate_iters=0 disables (default).
    # In `solve` the re-solve is guarded by lax.cond (zero cost on
    # converged ticks; under vmap the cond becomes a select and both
    # branches pay).  In `ipm_fast.solve_batched` only the worst
    # `escalate_capacity` lanes are gathered, re-solved as a sub-batch,
    # and scattered back — cost ~ (capacity/B) x (escalate_iters/iters).
    escalate_iters: int = dataclasses.field(default=0,
                                            metadata=dict(static=True))
    escalate_mu_tol: float = dataclasses.field(default=1e-9,
                                               metadata=dict(static=True))
    escalate_capacity: int = dataclasses.field(default=0,
                                               metadata=dict(static=True))


def certified_config(capacity: int = 0) -> IPMConfig:
    """The deliberate closed-loop/serving default: 8 Mehrotra iterations
    + per-tick escalation to 32 — the configuration certified <1e-4
    against the exact active-set oracle at EVERY tick including the
    1.5 m bang-bang transient (tools/bangbang_cert.py).

    Why this is the default and plain iters-8 is not: the flight-
    relevance study (tools/default_iters_flightcheck.py) measured the plain default's unconverged active-set-
    discovery ticks causing up to 0.21 m of closed-loop trajectory
    divergence and +7% LQ cost on the 1.5 m transient — not flight-
    irrelevant.  Escalation is mu-gated (escalate_mu_tol), so converged
    ticks pay nothing: `solve` guards the re-solve with lax.cond;
    `ipm_fast.solve_batched` cond-skips the gathered sub-solve unless a
    lane is unconverged (worst-case cost: bench.py "certified").

    capacity: escalation sub-batch size for the batched kernel path
    (ipm_fast) — pass the lane count (or the expected number of
    simultaneously-hard lanes); 0 is correct for the single-lane
    `solve` path which ignores it.
    """
    return IPMConfig(iters=8, escalate_iters=32,
                     escalate_capacity=capacity)


def _max_step(v, dv, tau):
    """Fraction-to-boundary: largest alpha <= 1 with v + alpha dv >= (1-tau)v.

    Per-problem scalar (reduces over all bound entries). Entries with
    non-negative dv never bind.
    """
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, tau * jnp.min(ratio))


@highest_precision
def init_state(qp: QPData, config: IPMConfig = IPMConfig(),
               lam0_l=None, lam0_u=None):
    """Initial IPM iterate + affine KKT residuals (z = 0 start).

    lam0_l/lam0_u ((N, nu), optional, EXPERIMENTAL): warm-start bound
    duals.  NOTE: cold duals are the default on purpose — they match
    acados/HPIPM's default QP warm-start behavior (primal-only carryover
    via the trajectory iterate), and carrying converged duals across RTI
    ticks measurably degrades the barrier (products collapse, KKT stalls)
    on short-horizon saturating transients.  Clipped away from zero so
    the first barrier iteration stays interior.
    """
    N, nx = qp.c.shape[-2], qp.c.shape[-1]
    nu = qp.ru.shape[-1]
    dtype = qp.c.dtype

    finite_l = jnp.isfinite(qp.lb)
    finite_u = jnp.isfinite(qp.ub)
    lb = jnp.where(finite_l, qp.lb, 0.0)
    ub = jnp.where(finite_u, qp.ub, 0.0)

    # initial point: z = 0, slacks at (clipped) distance to the bounds,
    # duals matching a unit barrier parameter.
    z_du = jnp.zeros((N, nu), dtype)
    z_dx = jnp.zeros((N + 1, nx), dtype)
    s_l = jnp.where(finite_l, jnp.maximum(-lb, config.s_min_init), 1.0)
    s_u = jnp.where(finite_u, jnp.maximum(ub, config.s_min_init), 1.0)
    mu0 = jnp.asarray(config.mu0_init, dtype)
    lam_l = jnp.where(finite_l, mu0 / s_l, 0.0)
    lam_u = jnp.where(finite_u, mu0 / s_u, 0.0)
    lam_min = 1e-4
    if lam0_l is not None:
        lam_l = jnp.where(finite_l, jnp.maximum(lam0_l, lam_min), 0.0)
    if lam0_u is not None:
        lam_u = jnp.where(finite_u, jnp.maximum(lam0_u, lam_min), 0.0)

    # affine residuals at the initial point (equality duals nu = 0):
    #   r1 = Hz + g - P'lam_l + P'lam_u  (z=0 => just gradients +/- duals)
    r1x = jnp.concatenate([qp.qx, qp.p[None]], axis=0)
    r1u = qp.ru - lam_l + lam_u
    #   r2: dynamics rows stacked as [x0 row; defect rows], Ez - e at z=0
    r2 = jnp.concatenate([-qp.dx0[None], -qp.c], axis=0)
    r3 = jnp.where(finite_l, -lb - s_l, 0.0)
    r4 = jnp.where(finite_u, ub - s_u, 0.0)
    return (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4)


@highest_precision
def iterate(qp: QPData, config: IPMConfig, carry):
    """One Mehrotra predictor-corrector iteration on the carried state."""
    (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry
    nu = qp.ru.shape[-1]
    dtype = qp.c.dtype
    finite_l = jnp.isfinite(qp.lb)
    finite_u = jnp.isfinite(qp.ub)
    n_ineq = jnp.maximum(jnp.sum(finite_l) + jnp.sum(finite_u), 1)

    mu = (jnp.sum(lam_l * s_l * finite_l) + jnp.sum(lam_u * s_u * finite_u)
          ) / n_ineq
    sig_l = jnp.where(finite_l, lam_l / s_l, 0.0)
    sig_u = jnp.where(finite_u, lam_u / s_u, 0.0)
    sigma_diag = sig_l + sig_u

    # ---- predictor (affine scaling, sigma = 0)
    r5l = lam_l * s_l
    r5u = lam_u * s_u
    rt1u = (r1u + jnp.where(finite_l, (r5l + lam_l * r3) / s_l, 0.0)
            - jnp.where(finite_u, (r5u + lam_u * r4) / s_u, 0.0))
    # NOTE: the LQ gradient pass is cheap; reuse factorization across
    # predictor and corrector by factorizing once here.
    Ruu_shift = qp.Ruu + jax.vmap(jnp.diag)(sigma_diag)
    if config.reg:
        Ruu_shift = Ruu_shift + config.reg * jnp.eye(nu, dtype=dtype)
    factors = riccati.factorize(qp.A, qp.B, qp.Qxx, Ruu_shift, qp.S, qp.P)

    def directions(rt1u_):
        k_ff, _ = riccati.backward_vector(
            factors, qp.A, qp.B, r1x[:-1], rt1u_, -r2[1:], r1x[-1])
        ddx, ddu = riccati.forward_rollout(
            factors, k_ff, qp.A, qp.B, -r2[1:], -r2[0])
        return ddx, ddu

    ddx_a, ddu_a = directions(rt1u)
    ds_l_a = jnp.where(finite_l, ddu_a + r3, 0.0)
    ds_u_a = jnp.where(finite_u, r4 - ddu_a, 0.0)
    dlam_l_a = jnp.where(finite_l, -(r5l + lam_l * ds_l_a) / s_l, 0.0)
    dlam_u_a = jnp.where(finite_u, -(r5u + lam_u * ds_u_a) / s_u, 0.0)

    alpha_aff = jnp.minimum(
        jnp.minimum(_max_step(jnp.where(finite_l, s_l, 1.0), ds_l_a, 1.0),
                    _max_step(jnp.where(finite_u, s_u, 1.0), ds_u_a, 1.0)),
        jnp.minimum(_max_step(jnp.where(finite_l, lam_l, 1.0), dlam_l_a, 1.0),
                    _max_step(jnp.where(finite_u, lam_u, 1.0), dlam_u_a, 1.0)))
    mu_aff = (jnp.sum((lam_l + alpha_aff * dlam_l_a)
                      * (s_l + alpha_aff * ds_l_a) * finite_l)
              + jnp.sum((lam_u + alpha_aff * dlam_u_a)
                        * (s_u + alpha_aff * ds_u_a) * finite_u)) / n_ineq
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    sigma = jnp.clip((mu_aff / jnp.maximum(mu, tiny)) ** 3, 0.0, 1.0)

    # ---- corrector (centering + Mehrotra second-order term)
    r5l_c = r5l - sigma * mu + ds_l_a * dlam_l_a
    r5u_c = r5u - sigma * mu + ds_u_a * dlam_u_a
    rt1u_c = (r1u + jnp.where(finite_l, (r5l_c + lam_l * r3) / s_l, 0.0)
              - jnp.where(finite_u, (r5u_c + lam_u * r4) / s_u, 0.0))
    ddx, ddu = directions(rt1u_c)
    ds_l = jnp.where(finite_l, ddu + r3, 0.0)
    ds_u = jnp.where(finite_u, r4 - ddu, 0.0)
    dlam_l = jnp.where(finite_l, -(r5l_c + lam_l * ds_l) / s_l, 0.0)
    dlam_u = jnp.where(finite_u, -(r5u_c + lam_u * ds_u) / s_u, 0.0)

    alpha = jnp.minimum(
        jnp.minimum(
            _max_step(jnp.where(finite_l, s_l, 1.0), ds_l, config.tau),
            _max_step(jnp.where(finite_u, s_u, 1.0), ds_u, config.tau)),
        jnp.minimum(
            _max_step(jnp.where(finite_l, lam_l, 1.0), dlam_l, config.tau),
            _max_step(jnp.where(finite_u, lam_u, 1.0), dlam_u, config.tau)))

    # ---- Gondzio multiple centrality correctors: reuse the factorization
    # to push outlier complementarity products toward sigma*mu at an
    # enlarged trial step; keep a correction only if it lengthens the step.
    # The extra direction solves the SAME linear system with a pure
    # complementarity RHS (r1 = r2 = r3 = r4 = 0), so the exact
    # (1 - alpha) residual contraction below is unaffected.
    for _ in range(config.gondzio_correctors):
        mu_t = sigma * mu
        a_hat = jnp.minimum(alpha + 0.1, 1.0)
        v_l = (s_l + a_hat * ds_l) * (lam_l + a_hat * dlam_l)
        v_u = (s_u + a_hat * ds_u) * (lam_u + a_hat * dlam_u)
        t_l = jnp.where(finite_l,
                        jnp.clip(v_l, 0.1 * mu_t, 10.0 * mu_t) - v_l, 0.0)
        t_u = jnp.where(finite_u,
                        jnp.clip(v_u, 0.1 * mu_t, 10.0 * mu_t) - v_u, 0.0)
        # r5_g = -t  =>  linearized products gain +t
        rt1u_g = (jnp.where(finite_l, -t_l / s_l, 0.0)
                  + jnp.where(finite_u, t_u / s_u, 0.0))
        zc = jnp.zeros_like(r2[1:])
        k_g, _ = riccati.backward_vector(
            factors, qp.A, qp.B, jnp.zeros_like(r1x[:-1]), rt1u_g, zc,
            jnp.zeros_like(r1x[-1]))
        ddx_g, ddu_g = riccati.forward_rollout(
            factors, k_g, qp.A, qp.B, zc, jnp.zeros_like(r2[0]))
        ds_l_g = jnp.where(finite_l, ddu_g, 0.0)
        ds_u_g = jnp.where(finite_u, -ddu_g, 0.0)
        dlam_l_g = jnp.where(finite_l, (t_l - lam_l * ds_l_g) / s_l, 0.0)
        dlam_u_g = jnp.where(finite_u, (t_u - lam_u * ds_u_g) / s_u, 0.0)

        ds_l2 = ds_l + ds_l_g
        ds_u2 = ds_u + ds_u_g
        dlam_l2 = dlam_l + dlam_l_g
        dlam_u2 = dlam_u + dlam_u_g
        alpha2 = jnp.minimum(
            jnp.minimum(
                _max_step(jnp.where(finite_l, s_l, 1.0), ds_l2, config.tau),
                _max_step(jnp.where(finite_u, s_u, 1.0), ds_u2, config.tau)),
            jnp.minimum(
                _max_step(jnp.where(finite_l, lam_l, 1.0), dlam_l2,
                          config.tau),
                _max_step(jnp.where(finite_u, lam_u, 1.0), dlam_u2,
                          config.tau)))
        keep = alpha2 > alpha
        pick = lambda new, old: jnp.where(keep, new, old)
        ddx = pick(ddx + ddx_g, ddx)
        ddu = pick(ddu + ddu_g, ddu)
        ds_l, ds_u = pick(ds_l2, ds_l), pick(ds_u2, ds_u)
        dlam_l, dlam_u = pick(dlam_l2, dlam_l), pick(dlam_u2, dlam_u)
        alpha = jnp.maximum(alpha, alpha2)

    # Convergence freeze: once the duality gap is far below achievable
    # accuracy, stop moving — otherwise slacks/duals underflow to zero
    # and Sigma = lam/s hits 0/0.  eps^2-scaled so it adapts to f32/f64.
    # Only applies when inequalities exist (mu == 0 identically otherwise).
    has_ineq = (jnp.sum(finite_l) + jnp.sum(finite_u)) > 0
    mu_floor = 100.0 * jnp.asarray(jnp.finfo(dtype).eps, dtype) ** 2
    alpha = jnp.where(has_ineq & (mu <= mu_floor), 0.0, alpha)

    z_dx = z_dx + alpha * ddx
    z_du = z_du + alpha * ddu
    s_l = jnp.where(finite_l, s_l + alpha * ds_l, 1.0)
    s_u = jnp.where(finite_u, s_u + alpha * ds_u, 1.0)
    lam_l = jnp.where(finite_l, lam_l + alpha * dlam_l, 0.0)
    lam_u = jnp.where(finite_u, lam_u + alpha * dlam_u, 0.0)

    # affine residuals contract exactly by (1 - alpha) for a QP
    shrink = 1.0 - alpha
    carry = (z_dx, z_du, s_l, s_u, lam_l, lam_u,
             shrink * r1x, shrink * r1u, shrink * r2,
             shrink * r3, shrink * r4)
    return carry, (alpha, mu)


@highest_precision
def solve(qp: QPData, config: IPMConfig = IPMConfig(),
          lam0_l=None, lam0_u=None) -> IPMSolution:
    """Solve the box-constrained multistage QP.

    Infinite bounds are supported: entries with non-finite lb/ub are masked
    out of the barrier (slack frozen at 1, dual at 0).

    With `config.escalate_iters > 0` a problem whose final mu exceeds
    `config.escalate_mu_tol` is re-solved from scratch at the larger
    iteration budget (lax.cond — free when converged; a select under
    vmap).  stats gains an `escalated` flag; `alphas`/`mus` traces stay
    those of the primary solve (the escalated budget has a different
    length).
    """
    sol = _solve(qp, config, lam0_l, lam0_u)
    if config.escalate_iters <= 0:
        return sol
    esc_cfg = dataclasses.replace(config, iters=config.escalate_iters,
                                  escalate_iters=0, gondzio_correctors=0)

    def resolve(_):
        s2 = _solve(qp, esc_cfg, lam0_l, lam0_u)
        stats = dict(sol.stats)
        for k in ("mu", "res_stat", "res_eq", "res_ineq"):
            stats[k] = s2.stats[k]
        stats["escalated"] = jnp.int32(1)
        return IPMSolution(dx=s2.dx, du=s2.du, lam_l=s2.lam_l,
                           lam_u=s2.lam_u, stats=stats)

    def keep(_):
        stats = dict(sol.stats)
        stats["escalated"] = jnp.int32(0)
        return IPMSolution(dx=sol.dx, du=sol.du, lam_l=sol.lam_l,
                           lam_u=sol.lam_u, stats=stats)

    return jax.lax.cond(sol.stats["mu"] > config.escalate_mu_tol,
                        resolve, keep, None)


def _solve(qp: QPData, config: IPMConfig,
           lam0_l=None, lam0_u=None) -> IPMSolution:
    finite_l = jnp.isfinite(qp.lb)
    finite_u = jnp.isfinite(qp.ub)
    n_ineq = jnp.maximum(jnp.sum(finite_l) + jnp.sum(finite_u), 1)

    carry0 = init_state(qp, config, lam0_l=lam0_l, lam0_u=lam0_u)
    carry, (alphas, mus) = jax.lax.scan(
        lambda c, _: iterate(qp, config, c), carry0, None,
        length=config.iters)
    (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry

    mu_final = (jnp.sum(lam_l * s_l * finite_l)
                + jnp.sum(lam_u * s_u * finite_u)) / n_ineq
    stats = dict(
        mu=mu_final,
        alphas=alphas,
        mus=mus,
        res_stat=jnp.maximum(jnp.max(jnp.abs(r1x)), jnp.max(jnp.abs(r1u))),
        res_eq=jnp.max(jnp.abs(r2)),
        res_ineq=jnp.maximum(jnp.max(jnp.abs(r3)), jnp.max(jnp.abs(r4))),
    )
    return IPMSolution(dx=z_dx, du=z_du, lam_l=lam_l, lam_u=lam_u,
                       stats=stats)
