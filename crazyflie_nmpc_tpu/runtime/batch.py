"""Batched closed-loop runtimes: swarm and Monte-Carlo configurations.

BASELINE.json configs 3-4: many independent closed loops advanced in
lockstep — 256-drone swarms (the reference's one-thread-per-drone server
scaled 100x, crazyflie_server.cpp:1108) and 1k-scenario Monte-Carlo with
perturbed initial states.  The per-tick controller is the batched RTI
step, so a whole swarm tick is a handful of kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from crazyflie_nmpc_tpu.models.quadrotor import NU, NX, dynamics
from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.ops.integrators import integrate
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.rti import init_rti
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched


class SwarmResult(NamedTuple):
    x: jax.Array        # (T, B, nx) plant states
    u: jax.Array        # (T, B, nu) applied controls
    kkt_res: jax.Array  # (T, B)


def swarm_hover(spec: OCPSpec, x_inits: jax.Array, setpoints: jax.Array,
                steps: int, config: ipm.IPMConfig = ipm.IPMConfig(iters=8),
                plant_substeps: int = 1) -> SwarmResult:
    """Closed-loop regulation for B independent vehicles in lockstep.

    Args:
      x_inits: (B, nx) initial states; setpoints: (B, 3) hover targets.
    """
    B = x_inits.shape[0]
    N = spec.N
    dtype = x_inits.dtype
    uss = spec.params.hover_speed().astype(dtype)

    # per-vehicle regulation references
    def mk_ref(sp):
        y = jnp.zeros((NX + NU,), dtype)
        y = y.at[0:3].set(sp).at[3].set(1.0).at[NX:].set(uss)
        return jnp.broadcast_to(y, (N, NX + NU)), y[:NX]

    yrefs, yref_es = jax.vmap(mk_ref)(setpoints)

    states0 = jax.vmap(lambda x: init_rti(spec, x))(x_inits)

    def tick(carry, _):
        xs, states = carry
        states, out = rti_step_batched(spec, states, xs, yrefs, yref_es,
                                       config)
        u = out.u0
        xs_next = jax.vmap(
            lambda x, uu: integrate(dynamics, spec.params, x, uu, spec.dt,
                                    plant_substeps))(xs, u)
        return (xs_next, states), (xs, u, out.kkt_res)

    (_, _), (xs, us, kkts) = jax.lax.scan(tick, (x_inits, states0), None,
                                          length=steps)
    return SwarmResult(x=xs, u=us, kkt_res=kkts)


def monte_carlo_hover(spec: OCPSpec, key, batch: int, steps: int,
                      pos_scale: float = 0.2,
                      setpoint=(0.0, 0.0, 0.5), **kw) -> SwarmResult:
    """Monte-Carlo over initial positions perturbed around the set-point
    (config 3)."""
    from crazyflie_nmpc_tpu.models.quadrotor import hover_state
    dtype = jnp.float32
    base = hover_state(spec.params, pos=setpoint, dtype=dtype)
    offs = pos_scale * jax.random.normal(key, (batch, 3), dtype)
    x_inits = jax.vmap(lambda o: base.at[0:3].add(o))(offs)
    setpoints = jnp.broadcast_to(jnp.asarray(setpoint, dtype), (batch, 3))
    return swarm_hover(spec, x_inits, setpoints, steps, **kw)
