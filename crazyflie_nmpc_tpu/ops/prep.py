"""RTI preparation in plain JAX: ERK4 + analytic VDE + QP assembly.

The preparation phase linearizes the dynamics at every shooting stage and
assembles the diagonal-cost QP.  Stages are independent, so the whole phase
is one stage-parallel function over batch-last arrays ((N, 13, B) states,
(N, 4, B) inputs) that XLA fuses into a few elementwise kernels.  Three
ingredients:

  * batch-last channel layout: every dynamics channel and Jacobian entry
    is a (B,) lane vector;
  * the hand-derived Jacobians (models.quadrotor.dynamics_jacobians) kept
    in SPARSE form — df/dx has ~60 structural nonzeros of 169, so the
    chain-rule products J @ S cost ~60 row-FMAs instead of 169, and the
    whole VDE is ~6x fewer FLOPs than pushing 17 jacfwd tangents;
  * the RK4 tangent chain of `ops.integrators.step_with_sensitivities_vde`
    (K_i = J_i (I + gamma_i dt K_{i-1}), A = I + dt/6 sum b_i K_i).

`prep_condense2` adds block-2 partial condensing (`ops.sweeps.condense2`)
so the solver receives the M = N/2 condensed stages directly.

Exactness: equals `linearize_trajectory` + the diagonal QP assembly to
roundoff (tests/test_pallas_kernels.py::test_prep_*).  Dynamics/Jacobian
expressions mirror models/quadrotor.py (the reference ODE,
export_ode_model.py:85-97); any drift is caught by the parity test.
"""

from __future__ import annotations

import functools as _ft

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops.sweeps import condense2

NX = 13
NU = 4
NY = NX + NU
NPARAM = 9  # g0, mq, Ixx, Iyy, Izz, Cd, Ct, l, dt
# (dt rides the params vector because tf is a traced OCPSpec leaf)


def _stage_consts(p, x):
    """dt, the (13, 13, 1..) identity, dtype and lane shape of a stage."""
    bshape = x.shape[1:]
    eye = jnp.eye(NX, dtype=x.dtype).reshape((NX, NX) + (1,) * len(bshape))
    return p[8], eye, x.dtype, bshape


def _pinv(p):
    """(1/mq, 1/Ixx, 1/Iyy, 1/Izz), hoisted ONCE per VDE stage: the row
    functions below run 4x per RK4 step each, and a multiply by the
    reciprocal replaces every lane-wide mass/inertia division."""
    return 1.0 / p[1], 1.0 / p[2], 1.0 / p[3], 1.0 / p[4]


def _dyn_rows(p, x, u, pi=None):
    """13 dynamics channels as (B,) rows; x (13,B), u (4,B), p (9,) params."""
    g0, mq, Ixx, Iyy, Izz, Cd, Ct, l = (p[i] for i in range(8))
    imq, iIxx, iIyy, iIzz = pi if pi is not None else _pinv(p)
    q1, q2, q3, q4 = x[3], x[4], x[5], x[6]
    vbx, vby, vbz = x[7], x[8], x[9]
    wx, wy, wz = x[10], x[11], x[12]
    w1, w2, w3, w4 = u[0], u[1], u[2], u[3]

    dxq = (vbx * (2 * q1 * q1 + 2 * q2 * q2 - 1)
           - vby * (2 * q1 * q4 - 2 * q2 * q3)
           + vbz * (2 * q1 * q3 + 2 * q2 * q4))
    dyq = (vby * (2 * q1 * q1 + 2 * q3 * q3 - 1)
           + vbx * (2 * q1 * q4 + 2 * q2 * q3)
           - vbz * (2 * q1 * q2 - 2 * q3 * q4))
    dzq = (vbz * (2 * q1 * q1 + 2 * q4 * q4 - 1)
           - vbx * (2 * q1 * q3 - 2 * q2 * q4)
           + vby * (2 * q1 * q2 + 2 * q3 * q4))
    dq1 = -(q2 * wx) / 2 - (q3 * wy) / 2 - (q4 * wz) / 2
    dq2 = (q1 * wx) / 2 - (q4 * wy) / 2 + (q3 * wz) / 2
    dq3 = (q4 * wx) / 2 + (q1 * wy) / 2 - (q2 * wz) / 2
    dq4 = (q2 * wy) / 2 - (q3 * wx) / 2 + (q1 * wz) / 2
    thrust = (Ct * (w1 * w1 + w2 * w2 + w3 * w3 + w4 * w4)) * imq
    dvbx = vby * wz - vbz * wy + g0 * (2 * q1 * q3 - 2 * q2 * q4)
    dvby = vbz * wx - vbx * wz - g0 * (2 * q1 * q2 + 2 * q3 * q4)
    dvbz = (vbx * wy - vby * wx
            - g0 * (2 * q1 * q1 + 2 * q4 * q4 - 1) + thrust)
    dwx = -(Ct * l * (w1 * w1 + w2 * w2 - w3 * w3 - w4 * w4)
            - Iyy * wy * wz + Izz * wy * wz) * iIxx
    dwy = -(Ct * l * (w1 * w1 - w2 * w2 - w3 * w3 + w4 * w4)
            + Ixx * wx * wz - Izz * wx * wz) * iIyy
    dwz = -(Cd * (w1 * w1 - w2 * w2 + w3 * w3 - w4 * w4)
            - Ixx * wx * wy + Iyy * wx * wy) * iIzz
    return [dxq, dyq, dzq, dq1, dq2, dq3, dq4, dvbx, dvby, dvbz,
            dwx, dwy, dwz]


def _jx_entries(p, x, pi=None):
    """Sparse df/dx: {(row, col): (B,) value} — mirrors
    models.quadrotor.dynamics_jacobians."""
    g0 = p[0]
    Ixx, Iyy, Izz = p[2], p[3], p[4]
    _, iIxx, iIyy, iIzz = pi if pi is not None else _pinv(p)
    q1, q2, q3, q4 = x[3], x[4], x[5], x[6]
    vbx, vby, vbz = x[7], x[8], x[9]
    wx, wy, wz = x[10], x[11], x[12]
    J = {
        # dxq row
        (0, 3): 4 * q1 * vbx - 2 * q4 * vby + 2 * q3 * vbz,
        (0, 4): 4 * q2 * vbx + 2 * q3 * vby + 2 * q4 * vbz,
        (0, 5): 2 * q2 * vby + 2 * q1 * vbz,
        (0, 6): -2 * q1 * vby + 2 * q2 * vbz,
        (0, 7): 2 * q1 * q1 + 2 * q2 * q2 - 1,
        (0, 8): -(2 * q1 * q4 - 2 * q2 * q3),
        (0, 9): 2 * q1 * q3 + 2 * q2 * q4,
        # dyq row
        (1, 3): 4 * q1 * vby + 2 * q4 * vbx - 2 * q2 * vbz,
        (1, 4): 2 * q3 * vbx - 2 * q1 * vbz,
        (1, 5): 4 * q3 * vby + 2 * q2 * vbx + 2 * q4 * vbz,
        (1, 6): 2 * q1 * vbx + 2 * q3 * vbz,
        (1, 7): 2 * q1 * q4 + 2 * q2 * q3,
        (1, 8): 2 * q1 * q1 + 2 * q3 * q3 - 1,
        (1, 9): -(2 * q1 * q2 - 2 * q3 * q4),
        # dzq row
        (2, 3): 4 * q1 * vbz - 2 * q3 * vbx + 2 * q2 * vby,
        (2, 4): 2 * q4 * vbx + 2 * q1 * vby,
        (2, 5): -2 * q1 * vbx + 2 * q4 * vby,
        (2, 6): 4 * q4 * vbz + 2 * q2 * vbx + 2 * q3 * vby,
        (2, 7): -(2 * q1 * q3 - 2 * q2 * q4),
        (2, 8): 2 * q1 * q2 + 2 * q3 * q4,
        (2, 9): 2 * q1 * q1 + 2 * q4 * q4 - 1,
        # quaternion kinematics rows
        (3, 4): -wx / 2, (3, 5): -wy / 2, (3, 6): -wz / 2,
        (3, 10): -q2 / 2, (3, 11): -q3 / 2, (3, 12): -q4 / 2,
        (4, 3): wx / 2, (4, 5): wz / 2, (4, 6): -wy / 2,
        (4, 10): q1 / 2, (4, 11): -q4 / 2, (4, 12): q3 / 2,
        (5, 3): wy / 2, (5, 4): -wz / 2, (5, 6): wx / 2,
        (5, 10): q4 / 2, (5, 11): q1 / 2, (5, 12): -q2 / 2,
        (6, 3): wz / 2, (6, 4): wy / 2, (6, 5): -wx / 2,
        (6, 10): -q3 / 2, (6, 11): q2 / 2, (6, 12): q1 / 2,
        # body-velocity rows
        (7, 3): 2 * g0 * q3, (7, 4): -2 * g0 * q4, (7, 5): 2 * g0 * q1,
        (7, 6): -2 * g0 * q2,
        (7, 8): wz, (7, 9): -wy, (7, 11): -vbz, (7, 12): vby,
        (8, 3): -2 * g0 * q2, (8, 4): -2 * g0 * q1, (8, 5): -2 * g0 * q4,
        (8, 6): -2 * g0 * q3,
        (8, 7): -wz, (8, 9): wx, (8, 10): vbz, (8, 12): -vbx,
        (9, 3): -4 * g0 * q1, (9, 6): -4 * g0 * q4,
        (9, 7): wy, (9, 8): -wx, (9, 10): -vby, (9, 11): vbx,
        # angular-rate rows
        (10, 11): (Iyy - Izz) * wz * iIxx, (10, 12): (Iyy - Izz) * wy * iIxx,
        (11, 10): (Izz - Ixx) * wz * iIyy, (11, 12): (Izz - Ixx) * wx * iIyy,
        (12, 10): (Ixx - Iyy) * wy * iIzz, (12, 11): (Ixx - Iyy) * wx * iIzz,
    }
    return J


def _ju_rows(p, u, pi=None):
    """Sparse df/du rows: {row: [(col, (B,) value), ...]}."""
    Cd, Ct, l = p[5], p[6], p[7]
    w1, w2, w3, w4 = u[0], u[1], u[2], u[3]
    imq, iIxx, iIyy, iIzz = pi if pi is not None else _pinv(p)
    tcm = 2.0 * Ct * imq
    tlx = 2.0 * Ct * l * iIxx
    tly = 2.0 * Ct * l * iIyy
    tdz = 2.0 * Cd * iIzz
    return {
        9: [(0, tcm * w1), (1, tcm * w2), (2, tcm * w3), (3, tcm * w4)],
        10: [(0, -tlx * w1), (1, -tlx * w2), (2, tlx * w3), (3, tlx * w4)],
        11: [(0, -tly * w1), (1, tly * w2), (2, tly * w3), (3, -tly * w4)],
        12: [(0, -tdz * w1), (1, tdz * w2), (2, -tdz * w3), (3, tdz * w4)],
    }


def _jx_mul(J, S):
    """Sparse J (dict) @ dense S (13, m, *batch) -> (13, m, *batch)."""
    zero = jnp.zeros_like(S[0])
    rows = []
    for i in range(NX):
        acc = None
        for j in range(NX):
            e = J.get((i, j))
            if e is None:
                continue
            t = e * S[j]
            acc = t if acc is None else acc + t
        rows.append(zero if acc is None else acc)
    return jnp.stack(rows)


def _jx_dense(J, dtype, bshape):
    """Materialize the sparse Jacobian as (13, 13, *batch)."""
    zero = jnp.zeros(bshape, dtype)
    return jnp.stack([
        jnp.stack([J.get((i, j), zero) + zero for j in range(NX)])
        for i in range(NX)
    ])


def _ju_dense(Ju_rows, dtype, bshape):
    zero = jnp.zeros(bshape, dtype)
    return jnp.stack([
        jnp.stack([dict(Ju_rows.get(i, ())).get(j, zero) + zero
                   for j in range(NU)])
        for i in range(NX)
    ])


def _vde_stage_o2(p, x, u):
    """Reduced-order sensitivity variant (opt-in, `vde_order=2`): the
    STATE propagates through the exact ERK4 (x_next and hence the
    defect c are unchanged — the converged trajectory is the same),
    but A/B come from a 2nd-order midpoint expansion

        A ~= I + dt J(x2) + dt^2/2 J(x2)^2
        B ~= dt (G + dt/2 J(x2) G)

    instead of the full matrix VDE — 1 Jacobian evaluation + 2 sparse
    products instead of 4 + 6.  This is an INEXACT-Jacobian Gauss-
    Newton: each tick's QP (and so its control) shifts by the O(dt^3)
    sensitivity truncation."""
    pi = _pinv(p)
    dt, eye, dtype, bshape = _stage_consts(p, x)
    k1 = jnp.stack(_dyn_rows(p, x, u, pi))
    x2 = x + 0.5 * dt * k1
    k2 = jnp.stack(_dyn_rows(p, x2, u, pi))
    x3 = x + 0.5 * dt * k2
    k3 = jnp.stack(_dyn_rows(p, x3, u, pi))
    x4 = x + dt * k3
    k4 = jnp.stack(_dyn_rows(p, x4, u, pi))
    x_next = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    J2 = _jx_entries(p, x2, pi)
    J2d = _jx_dense(J2, dtype, bshape)
    A = eye + dt * J2d + (dt * dt / 2.0) * _jx_mul(J2, J2d)
    G = _ju_dense(_ju_rows(p, u, pi), dtype, bshape)
    Bm = dt * (G + (dt / 2.0) * _jx_mul(J2, G))
    return A, Bm, x_next


def _vde_stage(p, x, u):
    """One stage of ERK4 + closed-form matrix VDE.  Returns (A, Bm,
    x_next)."""
    pi = _pinv(p)     # 4 divides for the whole stage instead of ~44
    dt, eye, dtype, bshape = _stage_consts(p, x)
    k1 = jnp.stack(_dyn_rows(p, x, u, pi))
    J1 = _jx_entries(p, x, pi)
    x2 = x + 0.5 * dt * k1
    k2 = jnp.stack(_dyn_rows(p, x2, u, pi))
    J2 = _jx_entries(p, x2, pi)
    x3 = x + 0.5 * dt * k2
    k3 = jnp.stack(_dyn_rows(p, x3, u, pi))
    J3 = _jx_entries(p, x3, pi)
    x4 = x + dt * k3
    k4 = jnp.stack(_dyn_rows(p, x4, u, pi))
    J4 = _jx_entries(p, x4, pi)

    K1 = _jx_dense(J1, dtype, bshape)
    K2 = _jx_mul(J2, eye + 0.5 * dt * K1)
    K3 = _jx_mul(J3, eye + 0.5 * dt * K2)
    K4 = _jx_mul(J4, eye + dt * K3)
    A = eye + (dt / 6.0) * (K1 + 2 * K2 + 2 * K3 + K4)

    G = _ju_dense(_ju_rows(p, u, pi), dtype, bshape)
    M1 = G
    M2 = G + _jx_mul(J2, 0.5 * dt * M1)
    M3 = G + _jx_mul(J3, 0.5 * dt * M2)
    M4 = G + _jx_mul(J4, dt * M3)
    Bm = (dt / 6.0) * (M1 + 2 * M2 + 2 * M3 + M4)

    x_next = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return A, Bm, x_next


def _stage(p, vde_order, x, xn, u):
    vde = _vde_stage if vde_order == 4 else _vde_stage_o2
    A, Bm, x_next = vde(p, x, u)
    return A, Bm, x_next - xn


def prep(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu, params,
         vde_order: int = 4):
    """Per-stage QP data of one RTI preparation phase.

    Args (batch-last): x_traj (N+1, 13, B), u_traj (N, 4, B), yref
      (N, 17, B); q_diag (13,), r_diag (4,), lbu/ubu (4,); params (9,):
      [g0, mq, Ixx, Iyy, Izz, Cd, Ct, l, dt].
      vde_order: 4 (default) = exact ERK4 matrix VDE sensitivities; 2 =
      midpoint 2nd-order sensitivities on the exact ERK4 state
      propagation (inexact-Jacobian Gauss-Newton, opt-in).
    Returns (A, B, c, qx, ru, lb, ub), batch-last.  The (13, B)-sized
    terminal gradient and dx0 stay with the caller.
    """
    x, u = x_traj[:-1], u_traj
    A, Bm, c = jax.vmap(_ft.partial(_stage, params, vde_order))(
        x, x_traj[1:], u)
    qx = q_diag[:, None] * (x - yref[:, :NX])
    ru = r_diag[:, None] * (u - yref[:, NX:])
    lb = lbu[:, None] - u
    ub = ubu[:, None] - u
    return A, Bm, c, qx, ru, lb, ub


def prep_condense2(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu, params,
                   vde_order: int = 4):
    """Preparation + block-2 partial condensing: (x, u, yref) to the
    condensed QP data in one stage-parallel function.

    Specialized to the uniform diagonal stage cost of the reference OCP
    (generate_c_code.py:62-107), like the rest of the batched path.

    Returns (cnd, Ae, Be, c, lb, ub): `cnd` is the `ops.sweeps.condense2`
    output dict (Abar/Bbar/cbar/Qbar/S1T/R00/qbar/rbar, all (M, ..., B));
    Ae/Be the even-stage Jacobians for interior-state expansion; c the
    full-horizon defect (N, 13, B); lb/ub the per-original-input bounds
    (N, 4, B).
    """
    N = u_traj.shape[0]
    if N % 2 != 0:
        raise ValueError("prep_condense2 needs even N")
    A, Bm, c, qx, ru, lb, ub = prep(x_traj, u_traj, yref, q_diag, r_diag,
                                    lbu, ubu, params, vde_order)
    qxx = jnp.broadcast_to(q_diag[:, None], qx.shape)
    cnd = condense2(A, Bm, c, qxx, qx, ru)
    return cnd, A[0::2], Bm[0::2], c, lb, ub
