"""Explicit Runge-Kutta integration with forward sensitivities (TPU-native).

Replaces the reference's acados ERK sim solver and its CasADi-generated
forward VDE (variational differential equations):
  * the OCP integrator: 4-stage explicit RK over each 15 ms shooting interval
    (generate_c_code.py:142 `integrator_type='ERK'`),
  * the estimator's delay predictor: one ERK solve of length `delay`
    (acados_estimator.cpp:573-589 `sim_in_set("T", delay)`).

Instead of generated C code for the VDE, sensitivities come from `jax.jacfwd`
through the integrator — mathematically identical to the forward VDE (both
propagate 17 tangent directions through the same RK scheme), but traced and
fused by XLA.  Everything here is shape-static and scan/vmap/jit composable.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.ops.backend import highest_precision


def rk4_step(f: Callable, params, x: jax.Array, u: jax.Array, dt) -> jax.Array:
    """One classic 4-stage explicit Runge-Kutta step of xdot = f(params, x, u).

    Matches acados' default ERK butcher tableau (4 stages, num_steps=1 per
    shooting interval).
    """
    k1 = f(params, x, u)
    k2 = f(params, x + 0.5 * dt * k1, u)
    k3 = f(params, x + 0.5 * dt * k2, u)
    k4 = f(params, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate(f: Callable, params, x: jax.Array, u: jax.Array, T,
              num_steps: int = 1) -> jax.Array:
    """Integrate over a horizon T with `num_steps` equal RK4 sub-steps.

    Control is held constant (zero-order hold), like the acados sim solver the
    estimator uses for delay compensation (acados_estimator.cpp:573-589).
    `num_steps` is static (compile-time); the loop unrolls/scans cleanly.
    """
    dt = T / num_steps
    if num_steps == 1:
        return rk4_step(f, params, x, u, dt)

    def body(x, _):
        return rk4_step(f, params, x, u, dt), None

    x_final, _ = jax.lax.scan(body, x, None, length=num_steps)
    return x_final


def step_with_sensitivities(f: Callable, params, x: jax.Array, u: jax.Array,
                            dt, num_steps: int = 1):
    """Discrete step F(x,u) plus forward sensitivities A = dF/dx, B = dF/du.

    The TPU-native equivalent of the CasADi forward-VDE external function the
    generated acados solver calls each RTI preparation phase
    (acados_mpc.cpp:84 `forw_vde_casadi`).

    Returns (x_next (...,13), A (...,13,13), B (...,13,4)).
    """
    def step_fn(x_, u_):
        return integrate(f, params, x_, u_, dt * num_steps, num_steps)

    x_next = step_fn(x, u)
    A = jax.jacfwd(step_fn, argnums=0)(x, u)
    B = jax.jacfwd(step_fn, argnums=1)(x, u)
    return x_next, A, B


def rollout(f: Callable, params, x0: jax.Array, u_traj: jax.Array, dt,
            num_steps: int = 1) -> jax.Array:
    """Open-loop rollout: apply the control sequence u_traj (N, nu) from x0.

    Returns the state trajectory (N+1, nx) including x0.  Sequential by
    nature (each state feeds the next) -> `lax.scan`; batching comes from
    vmapping the whole rollout.
    """
    def body(x, u):
        x_next = integrate(f, params, x, u, dt * num_steps, num_steps)
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0, u_traj)
    return jnp.concatenate([x0[None, :], xs], axis=0)


@highest_precision
def linearize_trajectory(f: Callable, params, x_traj: jax.Array,
                         u_traj: jax.Array, dt, num_steps: int = 1):
    """Stage-parallel linearization of the discrete dynamics along a trajectory.

    The reference linearizes stages sequentially inside acados' RTI
    preparation; here all N shooting intervals linearize at once via `vmap` —
    the batched-small-Jacobian layout the TPU wants (SURVEY.md section 2.6
    "stage axis").

    Args:
      x_traj: (N+1, nx) state iterate, u_traj: (N, nu) control iterate.
    Returns:
      x_next (N, nx) = F(x_k, u_k), A (N, nx, nx), B (N, nx, nu).
    """
    step = functools.partial(step_with_sensitivities, f, params,
                             dt=dt, num_steps=num_steps)
    return jax.vmap(step)(x_traj[:-1], u_traj)


@highest_precision
def step_with_sensitivities_vde(params, x: jax.Array, u: jax.Array, dt):
    """RK4 discrete step + sensitivities via the closed-form matrix VDE.

    Propagates the full (nx, nx)/(nx, nu) tangent matrices through the four
    RK stages with the hand-derived `dynamics_jacobians` — the TPU-friendly
    restatement of the CasADi forward VDE (one pass of dense chain rules
    instead of 17 jacfwd tangent evaluations).  Equals
    `step_with_sensitivities(dynamics, ...)` to roundoff
    (tests/test_integrators.py).

    Shapes: x (..., 13), u (..., 4) ->
      (x_next (..., 13), A (..., 13, 13), B (..., 13, 4)).
    """
    from crazyflie_nmpc_tpu.models.quadrotor import (
        dynamics,
        dynamics_jacobians,
    )

    eye = jnp.eye(x.shape[-1], dtype=x.dtype)

    def f_and_jac(x_):
        return dynamics(params, x_, u), *dynamics_jacobians(params, x_, u)

    k1, J1, G1 = f_and_jac(x)
    k2, J2, G2 = f_and_jac(x + 0.5 * dt * k1)
    k3, J3, G3 = f_and_jac(x + 0.5 * dt * k2)
    k4, J4, G4 = f_and_jac(x + dt * k3)

    # tangent chain through the stages: Ki = d k_i/dx, Mi = d k_i/du
    K1 = J1
    K2 = J2 @ (eye + 0.5 * dt * K1)
    K3 = J3 @ (eye + 0.5 * dt * K2)
    K4 = J4 @ (eye + dt * K3)
    M1 = G1
    M2 = G2 + J2 @ (0.5 * dt * M1)
    M3 = G3 + J3 @ (0.5 * dt * M2)
    M4 = G4 + J4 @ (dt * M3)

    x_next = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    A = eye + (dt / 6.0) * (K1 + 2 * K2 + 2 * K3 + K4)
    B = (dt / 6.0) * (M1 + 2 * M2 + 2 * M3 + M4)
    return x_next, A, B


@highest_precision
def linearize_trajectory_vde(params, x_traj: jax.Array, u_traj: jax.Array,
                             dt):
    """`linearize_trajectory` on the closed-form VDE (num_steps=1 path)."""
    return jax.vmap(functools.partial(step_with_sensitivities_vde, params,
                                      dt=dt))(x_traj[..., :-1, :], u_traj)
