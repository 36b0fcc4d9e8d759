"""Batched-path parity vs the reference path: batch-last sweeps, stage-
parallel preparation and block-2 condensing, and the batched IPM.

The batched solver takes the cost as DIAGONALS (the reference LLS cost
structure: Qxx/Ruu/W_e diagonal, S = 0 — generate_c_code.py:62-129); the
reference `ops.riccati`/`ops.ipm` path consumes the same problems with the
diagonals embedded dense, so agreement checks both the algebra and the
structure exploitation.  These run the plain (`lax.scan`) sweeps; the GPU
sweep kernel is checked against them in tests/test_sweep_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crazyflie_nmpc_tpu.ops import ipm, ipm_fast, prep, riccati, sweeps
from crazyflie_nmpc_tpu.ops.qp import QPData

B = 8
N = 10
NXD, NUD = 13, 4
KERN = dict(sweep="plain")


def random_diag_lq(key, N=N, nx=NXD, nu=NUD, dtype=jnp.float32):
    """Random stage-structured LQ problem with diagonal cost (the batched
    solver's contract).  Dense embeddings included for the reference path."""
    ks = jax.random.split(key, 12)
    A = 0.9 * jax.random.normal(ks[0], (N, nx, nx), dtype) / float(np.sqrt(nx))
    A = A + jnp.eye(nx, dtype=dtype) * 0.5
    Bm = jax.random.normal(ks[1], (N, nx, nu), dtype)
    c = 0.1 * jax.random.normal(ks[2], (N, nx), dtype)
    qxx = 0.2 + jax.random.uniform(ks[3], (N, nx), dtype)
    ruu = 0.2 + jax.random.uniform(ks[4], (N, nu), dtype)
    qx = jax.random.normal(ks[6], (N, nx), dtype)
    ru = jax.random.normal(ks[7], (N, nu), dtype)
    pT = 0.2 + jax.random.uniform(ks[8], (nx,), dtype)
    p = jax.random.normal(ks[9], (nx,), dtype)
    dx0 = jax.random.normal(ks[10], (nx,), dtype)
    dense = dict(
        A=A, B=Bm, c=c, qx=qx, ru=ru, p_term=p, dx0=dx0,
        Qxx=jax.vmap(jnp.diag)(qxx),
        Ruu=jax.vmap(jnp.diag)(ruu),
        S=jnp.zeros((N, nu, nx), dtype),
        P_term=jnp.diag(pT),
    )
    return dict(A=A, B=Bm, c=c, qxx=qxx, ruu=ruu, qx=qx, ru=ru, pT=pT,
                p_term=p, dx0=dx0), dense


def batch_lq(key):
    keys = jax.random.split(key, B)
    pairs = [random_diag_lq(k) for k in keys]
    f32 = lambda *xs: jnp.stack(xs).astype(jnp.float32)
    diag = jax.tree.map(f32, *[d for d, _ in pairs])
    dense = jax.tree.map(f32, *[d for _, d in pairs])
    return diag, dense


def bl(x):
    return jnp.moveaxis(x, 0, -1)


def test_backward_forward_match_sequential():
    diag, dense = batch_lq(jax.random.PRNGKey(0))
    fr = jax.vmap(riccati.factorize)(dense["A"], dense["B"], dense["Qxx"],
                                     dense["Ruu"], dense["S"],
                                     dense["P_term"])
    kf_ref, _ = jax.vmap(riccati.backward_vector)(
        fr, dense["A"], dense["B"], dense["qx"], dense["ru"], dense["c"],
        dense["p_term"])
    dx_ref, du_ref = jax.vmap(riccati.forward_rollout)(
        fr, kf_ref, dense["A"], dense["B"], dense["c"], dense["dx0"])

    K, kff, L, Pc, dx, du = sweeps.kkt_sweep(
        bl(diag["A"]), bl(diag["B"]), bl(diag["c"]), bl(diag["qxx"]), None,
        None, bl(diag["qx"]), bl(diag["ruu"]), bl(diag["ru"]),
        bl(diag["pT"]), bl(diag["p_term"]), bl(diag["dx0"]))
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(K, -1, 0)),
                               np.asarray(fr.K), rtol=2e-4, atol=2e-4)
    # Pc[k] must be P_{k+1} c_k
    Pc_ref = jnp.einsum("bnij,bnj->bni", fr.P[:, 1:], dense["c"])
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(Pc, -1, 0)),
                               np.asarray(Pc_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(kff, -1, 0)),
                               np.asarray(kf_ref), rtol=2e-4, atol=2e-4)

    np.testing.assert_allclose(np.asarray(jnp.moveaxis(du, -1, 0)),
                               np.asarray(du_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(dx, -1, 0)),
                               np.asarray(dx_ref), rtol=2e-4, atol=2e-4)


def test_vector_sweep_second_rhs():
    diag, dense = batch_lq(jax.random.PRNGKey(1))
    fr = jax.vmap(riccati.factorize)(dense["A"], dense["B"], dense["Qxx"],
                                     dense["Ruu"], dense["S"],
                                     dense["P_term"])
    kf2_ref, _ = jax.vmap(riccati.backward_vector)(
        fr, dense["A"], dense["B"], 2.0 * dense["qx"], -0.5 * dense["ru"],
        dense["c"], 0.3 * dense["p_term"])
    dx_ref, du_ref = jax.vmap(riccati.forward_rollout)(
        fr, kf2_ref, dense["A"], dense["B"], dense["c"], dense["dx0"])

    K, kff, L, Pc, _, _ = sweeps.kkt_sweep(
        bl(diag["A"]), bl(diag["B"]), bl(diag["c"]), bl(diag["qxx"]), None,
        None, bl(diag["qx"]), bl(diag["ruu"]), bl(diag["ru"]),
        bl(diag["pT"]), bl(diag["p_term"]), bl(diag["dx0"]))
    dx2, du2 = sweeps.corrector_sweep(
        bl(diag["A"]), bl(diag["B"]), bl(diag["c"]), bl(2.0 * diag["qx"]),
        bl(-0.5 * diag["ru"]), K, L, Pc, bl(0.3 * diag["p_term"]),
        bl(diag["dx0"]))
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(du2, -1, 0)),
                               np.asarray(du_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(dx2, -1, 0)),
                               np.asarray(dx_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bounded", [False, True])
def test_ipm_fast_matches_ipm(bounded):
    """Full fast-IPM vs reference IPM on a batch of bounded diag-cost QPs."""
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    qps = []
    for k in keys:
        diag, dense = random_diag_lq(k)
        lq = dict(A=dense["A"], B=dense["B"], c=dense["c"],
                  Qxx=dense["Qxx"], qx=dense["qx"], Ruu=dense["Ruu"],
                  ru=dense["ru"], S=dense["S"], P_term=dense["P_term"],
                  p_term=dense["p_term"], dx0=dense["dx0"])
        lb = jnp.full((N, NUD), -jnp.inf)
        ub = jnp.full((N, NUD), jnp.inf)
        if bounded:
            _, du_ref = riccati.solve_lq(**lq)
            lim = 0.5 * float(jnp.max(jnp.abs(du_ref)))
            lb = jnp.full((N, NUD), -lim)
            ub = jnp.full((N, NUD), lim)
        qps.append(QPData(A=lq["A"], B=lq["B"], c=lq["c"], Qxx=lq["Qxx"],
                          qx=lq["qx"], Ruu=lq["Ruu"], ru=lq["ru"],
                          S=lq["S"], P=lq["P_term"], p=lq["p_term"],
                          lb=lb, ub=ub, dx0=lq["dx0"]))
    batched = jax.tree.map(
        lambda *xs: jnp.stack(xs).astype(jnp.float32), *qps)

    cfg = ipm.IPMConfig(iters=8)
    ref = jax.vmap(lambda q: ipm.solve(q, cfg))(batched)
    fast = ipm_fast.solve_batched(ipm_fast.from_qpdata(batched), cfg,
                                  **KERN)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(fast.du, -1, 0)),
                               np.asarray(ref.du), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(fast.dx, -1, 0)),
                               np.asarray(ref.dx), rtol=5e-3, atol=5e-4)


def test_rti_step_batched_matches_rti_step():
    from crazyflie_nmpc_tpu.models import hover_state, NX
    from crazyflie_nmpc_tpu.solver import (
        default_ocp,
        hover_yref,
        init_rti,
        rti_step,
    )
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(3)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.03 * jax.random.normal(key, (B, NX), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    cfg = ipm.IPMConfig(iters=6)

    new_b, out_b = rti_step_batched(spec, states, x0s, yref, yref_e, cfg)
    ref_step = jax.jit(lambda s, x: rti_step(spec, s, x, yref, yref_e, cfg))
    for i in range(0, B, 3):
        si = jax.tree.map(lambda a: a[i], states)
        _, oi = ref_step(si, x0s[i])
        np.testing.assert_allclose(np.asarray(out_b.u0[i]),
                                   np.asarray(oi.u0), rtol=1e-3, atol=1e-3)


def _prep_args(spec, x_traj, u, yref, dt=None):
    """Batch-last arguments of `ops.prep.prep` for batch-first states."""
    dtype = x_traj.dtype
    par = spec.params
    params = jnp.array([par.g0, par.mq, par.Ixx, par.Iyy, par.Izz, par.Cd,
                        par.Ct, par.l,
                        float(spec.dt) if dt is None else dt], dtype)
    blm = lambda z: jnp.moveaxis(z, 0, -1)
    Bt = x_traj.shape[0]
    return (blm(x_traj), blm(u),
            jnp.broadcast_to(yref[:, :, None], yref.shape + (Bt,)),
            jnp.diagonal(spec.cost.W)[:13].astype(dtype),
            jnp.diagonal(spec.cost.W)[13:].astype(dtype),
            spec.lbu.astype(dtype), spec.ubu.astype(dtype), params)


def test_prep_kernel_matches_xla_path():
    """Stage-parallel ERK4 + sparse VDE + assembly (ops.prep) == jacfwd
    linearization + diagonal QP assembly (the rti_step_batched
    preparation phase)."""
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.models.quadrotor import dynamics
    from crazyflie_nmpc_tpu.ops.integrators import linearize_trajectory
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(9)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.05 * jax.random.normal(key, (B, 13), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    # gently perturbed controls so B-sensitivities are exercised
    u = states.u_traj + 0.3 * jax.random.normal(
        jax.random.fold_in(key, 1), states.u_traj.shape, jnp.float32)

    # reference: XLA path
    xn, A_ref, B_ref = jax.vmap(
        lambda xt, ut: linearize_trajectory(dynamics, spec.params, xt, ut,
                                            spec.dt, spec.sim_steps)
    )(states.x_traj, u)
    blm = lambda z: jnp.moveaxis(z, 0, -1)
    c_ref = blm(xn - states.x_traj[:, 1:])
    q_diag = jnp.diagonal(spec.cost.W)[:13]
    r_diag = jnp.diagonal(spec.cost.W)[13:]
    qx_ref = blm(q_diag * (states.x_traj[:, :-1] - yref[None, :, :13]))
    ru_ref = blm(r_diag * (u - yref[None, :, 13:]))

    # batched stage-parallel preparation
    A_k, B_k, c_k, qx_k, ru_k, lb_k, ub_k = prep.prep(
        *_prep_args(spec, states.x_traj, u, yref))

    np.testing.assert_allclose(np.asarray(A_k), np.asarray(blm(A_ref)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(B_k), np.asarray(blm(B_ref)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(qx_k), np.asarray(qx_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ru_k), np.asarray(ru_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lb_k),
                               np.asarray(blm(spec.lbu - u)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ub_k),
                               np.asarray(blm(spec.ubu - u)), rtol=1e-6)


def test_prep_vde_order2_truncation_is_third_order():
    """vde_order=2 (midpoint sensitivities on the exact ERK4 state):
    the state/defect outputs are IDENTICAL to the exact path, and the
    A/B truncation error vs the exact matrix VDE shrinks ~8x when dt
    halves (3rd-order), pinning that the o2 path implements the
    documented expansion and nothing else."""
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, _ = hover_yref(spec)
    key = jax.random.PRNGKey(13)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.05 * jax.random.normal(key, (B, 13), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    u = states.u_traj + 0.5 * jax.random.normal(
        jax.random.fold_in(key, 1), states.u_traj.shape, jnp.float32)

    def run(dt, order):
        return prep.prep(*_prep_args(spec, states.x_traj, u, yref, dt),
                         vde_order=order)

    errs = {}
    for dt in (0.015, 0.0075):
        A4, B4, c4, *_ = run(dt, 4)
        A2, B2, c2, *_ = run(dt, 2)
        # exact state propagation shared: defects identical
        np.testing.assert_allclose(np.asarray(c2), np.asarray(c4),
                                   rtol=0, atol=1e-7)
        errs[dt] = (float(jnp.max(jnp.abs(A2 - A4))),
                    float(jnp.max(jnp.abs(B2 - B4))))
    ra = errs[0.015][0] / errs[0.0075][0]
    rb = errs[0.015][1] / errs[0.0075][1]
    assert errs[0.015][0] > 1e-6          # above f32 noise: a real signal
    assert 4.5 < ra < 14.0, (errs, ra)    # ~8x = 3rd-order truncation
    assert 4.5 < rb < 14.0, (errs, rb)


def test_prep_condense2_matches_two_launch():
    """prep_condense2 (preparation + block-2 condensing in one stage-
    parallel function) == prep followed by condense2, and the pair
    condensing run stage by stage — exact reorganization."""
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    Bt = 8
    spec = default_ocp(N=10, dtype=jnp.float64)
    yref, _ = hover_yref(spec)
    key = jax.random.PRNGKey(21)
    x0s = (hover_state(spec.params, dtype=jnp.float64)[None, :]
           + 0.05 * jax.random.normal(key, (Bt, 13), jnp.float64))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    u = states.u_traj + 0.3 * jax.random.normal(
        jax.random.fold_in(key, 1), states.u_traj.shape, jnp.float64)
    args = _prep_args(spec, states.x_traj, u, yref)

    A_k, B_k, c_k, qx_k, ru_k, lb_k, ub_k = prep.prep(*args)
    q_diag = args[3]
    qxx = jnp.broadcast_to(q_diag[None, :, None], (10, 13, Bt))
    cnd_ref = sweeps.condense2(A_k, B_k, c_k, qxx, qx_k, ru_k)
    # stage by stage: pair 2 of the horizon through condense_pair alone
    one = sweeps.condense_pair(A_k[4], A_k[5], B_k[4], B_k[5], c_k[4],
                               c_k[5], qxx[4], qxx[5], qx_k[4], qx_k[5],
                               ru_k[4], ru_k[5])

    cnd, Ae, Be, c2, lb2, ub2 = prep.prep_condense2(*args)
    for k in cnd_ref:
        np.testing.assert_allclose(np.asarray(cnd[k][2]),
                                   np.asarray(one[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(np.asarray(cnd[k]),
                                   np.asarray(cnd_ref[k]),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(np.asarray(Ae), np.asarray(A_k[0::2]),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(Be), np.asarray(B_k[0::2]),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c_k),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(lb2), np.asarray(lb_k),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ub2), np.asarray(ub_k),
                               rtol=1e-12)


def test_rti_batched_fused_prep_condense_matches():
    """End to end: the production path (prep_condense2 hands the solver
    precondensed data) solves the same problem as condensing inside the
    IPM from the uncondensed preparation (same IPM, same outputs)."""
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import (
        rti_step_batched, to_batch_last)

    Bt = 8
    spec = default_ocp(N=10, dtype=jnp.float64)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(22)
    x0s = (hover_state(spec.params, dtype=jnp.float64)[None, :]
           + jnp.concatenate([
               0.3 * jax.random.normal(key, (Bt, 3), jnp.float64),
               0.02 * jax.random.normal(key, (Bt, 10), jnp.float64)],
               axis=1))
    states = to_batch_last(jax.vmap(lambda x: init_rti(spec, x))(x0s))

    cfg = ipm.IPMConfig()
    s1, o1 = rti_step_batched(spec, states, x0s, yref, yref_e, cfg,
                              layout="batch_last", **KERN)

    # the same step by hand: uncondensed preparation, condensed in the IPM
    u_bf = jnp.moveaxis(states.u_traj, -1, 0)
    x_bf = jnp.moveaxis(states.x_traj, -1, 0)
    A_k, B_k, c_k, qx_k, ru_k, lb_k, ub_k = prep.prep(
        *_prep_args(spec, x_bf, u_bf, yref))
    q = jnp.diagonal(spec.cost.W)[:13]
    r = jnp.diagonal(spec.cost.W)[13:]
    pT = jnp.diagonal(spec.cost.W_e)
    qp = dict(A=A_k, B=B_k, c=c_k, qx=qx_k, ru=ru_k, lb=lb_k, ub=ub_k,
              qxx=jnp.broadcast_to(q[None, :, None], (10, 13, Bt)),
              ruu=jnp.broadcast_to(r[None, :, None], (10, 4, Bt)),
              pT=jnp.broadcast_to(pT[:, None], (13, Bt)),
              p=pT[:, None] * (states.x_traj[-1] - yref_e[:, None]),
              dx0=x0s.T - states.x_traj[0])
    sol = ipm_fast.solve_batched(qp, cfg, condense=2, **KERN)
    np.testing.assert_allclose(np.asarray(o1.u_plan),
                               np.asarray(states.u_traj + sol.du),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(o1.x_plan),
                               np.asarray(states.x_traj + sol.dx),
                               rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# block-2 partial condensing (the reference's PARTIAL_CONDENSING_HPIPM
# structure, generate_c_code.py:140) — condensing + solver path
# ---------------------------------------------------------------------------

def test_condense2_matches_einsum_reference():
    """Block-2 condensing is an exact algebraic elimination; pin the
    broadcast-FMA form against an einsum construction."""
    diag, dense = batch_lq(jax.random.PRNGKey(7))
    A, Bm, c = diag["A"], diag["B"], diag["c"]         # (B, N, ...)
    qxx, qx, ru = diag["qxx"], diag["qx"], diag["ru"]

    cnd = sweeps.condense2(bl(A), bl(Bm), bl(c), bl(qxx), bl(qx), bl(ru))

    A0, A1 = A[:, 0::2], A[:, 1::2]
    B0, B1 = Bm[:, 0::2], Bm[:, 1::2]
    c0, c1 = c[:, 0::2], c[:, 1::2]
    q0, q1 = qxx[:, 0::2], qxx[:, 1::2]
    mm = lambda X, Y: jnp.einsum("bkij,bkjl->bkil", X, Y)
    mv = lambda X, y: jnp.einsum("bkij,bkj->bki", X, y)
    tr = lambda X: jnp.swapaxes(X, -1, -2)

    Abar = mm(A1, A0)
    Bbar = jnp.concatenate([mm(A1, B0), B1], axis=-1)
    cbar = mv(A1, c0) + c1
    qA = q1[..., :, None] * A0
    Qbar = mm(tr(A0), qA) + jax.vmap(jax.vmap(jnp.diag))(q0)
    S1T = mm(tr(B0), qA)
    R00 = mm(tr(B0), q1[..., :, None] * B0)
    h = q1 * c0 + qx[:, 1::2]
    qbar = qx[:, 0::2] + mv(tr(A0), h)
    rbar = jnp.concatenate([ru[:, 0::2] + mv(tr(B0), h), ru[:, 1::2]],
                           axis=-1)

    for name, got, want in (("Abar", cnd["Abar"], Abar),
                            ("Bbar", cnd["Bbar"], Bbar),
                            ("cbar", cnd["cbar"], cbar),
                            ("Qbar", cnd["Qbar"], Qbar),
                            ("S1T", cnd["S1T"], S1T),
                            ("R00", cnd["R00"], R00),
                            ("qbar", cnd["qbar"], qbar),
                            ("rbar", cnd["rbar"], rbar)):
        np.testing.assert_allclose(
            np.asarray(jnp.moveaxis(got, -1, 0)), np.asarray(want),
            rtol=2e-5, atol=2e-5, err_msg=name)


def test_ipm_fast_condensed_matches_ipm():
    """Condensed-path IPM vs the reference `ops.ipm` on bounded QPs —
    block-2 condensing is an exact reparametrization, so the solutions
    (and in fact the iterates) must agree."""
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    qps = []
    for k in keys:
        diag, dense = random_diag_lq(k)
        _, du_ref = riccati.solve_lq(
            A=dense["A"], B=dense["B"], c=dense["c"], Qxx=dense["Qxx"],
            qx=dense["qx"], Ruu=dense["Ruu"], ru=dense["ru"], S=dense["S"],
            P_term=dense["P_term"], p_term=dense["p_term"],
            dx0=dense["dx0"])
        lim = 0.5 * float(jnp.max(jnp.abs(du_ref)))
        qps.append(QPData(A=dense["A"], B=dense["B"], c=dense["c"],
                          Qxx=dense["Qxx"], qx=dense["qx"],
                          Ruu=dense["Ruu"], ru=dense["ru"], S=dense["S"],
                          P=dense["P_term"], p=dense["p_term"],
                          lb=jnp.full((N, NUD), -lim),
                          ub=jnp.full((N, NUD), lim), dx0=dense["dx0"]))
    batched = jax.tree.map(
        lambda *xs: jnp.stack(xs).astype(jnp.float32), *qps)

    cfg = ipm.IPMConfig(iters=8)
    ref = jax.vmap(lambda q: ipm.solve(q, cfg))(batched)
    fast = ipm_fast.solve_batched(ipm_fast.from_qpdata(batched), cfg,
                                  condense=2, **KERN)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(fast.du, -1, 0)),
                               np.asarray(ref.du), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(fast.dx, -1, 0)),
                               np.asarray(ref.dx), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(fast.lam_l, -1, 0)),
                               np.asarray(ref.lam_l), rtol=5e-3, atol=5e-3)


def test_rti_step_batched_condensed_matches_plain():
    from crazyflie_nmpc_tpu.models import hover_state, NX
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(9)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.03 * jax.random.normal(key, (B, NX), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    cfg = ipm.IPMConfig(iters=8)

    _, out1 = rti_step_batched(spec, states, x0s, yref, yref_e, cfg,
                               condense=1)
    _, out2 = rti_step_batched(spec, states, x0s, yref, yref_e, cfg,
                               condense=2)
    # f32 + 8 barrier iterations: the two paths take different arithmetic
    # routes to the same QP solution; agreement is tight but not bitwise
    np.testing.assert_allclose(np.asarray(out2.u0), np.asarray(out1.u0),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out2.x_plan),
                               np.asarray(out1.x_plan), rtol=1e-2,
                               atol=3e-3)


def test_rti_step_batched_batch_last_layout():
    """batch_last layout must produce the same numbers as batch_first
    (it is the same computation minus two layout transposes)."""
    from crazyflie_nmpc_tpu.models import hover_state, NX
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import (
        rti_step_batched,
        to_batch_first,
        to_batch_last,
    )

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(11)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.03 * jax.random.normal(key, (B, NX), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    cfg = ipm.IPMConfig(iters=6)
    kw = dict(condense=2)

    new1, out1 = rti_step_batched(spec, states, x0s, yref, yref_e, cfg,
                                  **kw)
    new2, out2 = rti_step_batched(spec, to_batch_last(states), x0s, yref,
                                  yref_e, cfg, layout="batch_last", **kw)
    new2_bf = to_batch_first(new2)
    np.testing.assert_allclose(np.asarray(new2_bf.u_traj),
                               np.asarray(new1.u_traj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(out2.u0, -1, 0)),
                               np.asarray(out1.u0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out2.kkt_res),
                               np.asarray(out1.kkt_res), rtol=1e-6,
                               atol=1e-6)


def test_ipm_fast_gondzio_matches_ipm():
    """Gondzio centrality correctors: fused batched path == reference path
    (bounded problems, correctors accepted per lane)."""
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    qps = []
    for k in keys:
        diag, dense = random_diag_lq(k)
        lq = dict(A=dense["A"], B=dense["B"], c=dense["c"],
                  Qxx=dense["Qxx"], qx=dense["qx"], Ruu=dense["Ruu"],
                  ru=dense["ru"], S=dense["S"], P_term=dense["P_term"],
                  p_term=dense["p_term"], dx0=dense["dx0"])
        _, du_ref = riccati.solve_lq(**lq)
        lim = 0.5 * float(jnp.max(jnp.abs(du_ref)))
        qps.append(QPData(A=lq["A"], B=lq["B"], c=lq["c"], Qxx=lq["Qxx"],
                          qx=lq["qx"], Ruu=lq["Ruu"], ru=lq["ru"],
                          S=lq["S"], P=lq["P_term"], p=lq["p_term"],
                          lb=jnp.full((N, NUD), -lim),
                          ub=jnp.full((N, NUD), lim), dx0=lq["dx0"]))
    batched = jax.tree.map(
        lambda *xs: jnp.stack(xs).astype(jnp.float32), *qps)

    cfg = ipm.IPMConfig(iters=5, gondzio_correctors=2)
    ref = jax.vmap(lambda q: ipm.solve(q, cfg))(batched)
    for condense in (1, 2):
        fast = ipm_fast.solve_batched(ipm_fast.from_qpdata(batched), cfg,
                                      condense=condense, **KERN)
        np.testing.assert_allclose(
            np.asarray(jnp.moveaxis(fast.du, -1, 0)), np.asarray(ref.du),
            rtol=5e-3, atol=5e-4, err_msg=f"condense={condense}")
    # and the correctors actually tighten centrality vs plain Mehrotra
    plain = jax.vmap(lambda q: ipm.solve(
        q, ipm.IPMConfig(iters=5)))(batched)
    assert float(jnp.median(ref.stats["mu"])) < float(
        jnp.median(plain.stats["mu"]))
