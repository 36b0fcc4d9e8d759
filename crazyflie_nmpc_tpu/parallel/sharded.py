"""Sharded NMPC execution over a (batch, stage) device mesh.

Two composable parallel axes (replacing the reference's one-thread-per-drone
concurrency, crazyflie_server.cpp:155,1108-1131, with SPMD over a mesh):

  * batch: independent OCP instances sharded across devices; solves never
    communicate (metrics reduce with psum if asked).
  * stage: the prediction horizon's heavy per-stage work — ERK4+jacobian
    linearization and partial condensing — computed on the device owning
    that block of stages.  Only the small condensed problem (N/b reduced
    stages of (nx, b*nu) blocks) is all-gathered over ICI; the reduced
    Riccati/IPM runs replicated (it is tiny), and expansion is local again.

State trajectories are KB-sized, so they stay replicated along `stage`;
what is sharded is the *compute* (jacfwd rollouts, condensing matmuls) and
its outputs.  This is the right trade for this problem shape — collective
payloads are small and every device's MXU works on its own stage block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from crazyflie_nmpc_tpu.models.quadrotor import NU, NX, dynamics
from crazyflie_nmpc_tpu.ops import condensing, ipm
from crazyflie_nmpc_tpu.ops.backend import highest_precision
from crazyflie_nmpc_tpu.ops.integrators import linearize_trajectory
from crazyflie_nmpc_tpu.ops.qp import build_qp, gauss_newton_cost_blocks
from crazyflie_nmpc_tpu.parallel.mesh import BATCH_AXIS, STAGE_AXIS
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.rti import RTIOutput, RTIState, rti_step


def batch_sharded_rti(spec: OCPSpec, mesh,
                      config: ipm.IPMConfig = ipm.IPMConfig()):
    """Jitted batched RTI step with the batch dim sharded over the mesh.

    Returns fn(states, x0s, yrefs, yref_es) -> (states', outs); all leading
    dims are global batch, laid out over the mesh's batch axis.  XLA
    partitions the vmapped solves with zero communication.
    """
    batch_sharding = NamedSharding(mesh, P(BATCH_AXIS))

    @functools.partial(jax.jit,
                       in_shardings=(batch_sharding,) * 4,
                       out_shardings=batch_sharding)
    def step(states, x0s, yrefs, yref_es):
        return jax.vmap(
            lambda s, x, yr, ye: rti_step(spec, s, x, yr, ye, config)
        )(states, x0s, yrefs, yref_es)

    return step


@highest_precision
def stage_sharded_rti_step(spec: OCPSpec, mesh, block: int,
                           state: RTIState, x0, yref, yref_e,
                           config: ipm.IPMConfig = ipm.IPMConfig()):
    """One RTI step with linearization + condensing sharded over STAGE_AXIS.

    The trajectory iterate is replicated; each of the `d` stage-devices
    linearizes and condenses its N/d-stage chunk, the condensed stage
    problems are all-gathered (small), the reduced IPM runs replicated, and
    each device expands its local chunk.
    """
    n_stage = mesh.shape[STAGE_AXIS]
    N = spec.N
    if N % (n_stage * block) != 0:
        raise ValueError(
            f"N={N} must be divisible by stage_devices*block="
            f"{n_stage * block}")
    chunk = N // n_stage

    cost = spec.cost

    def local_work(x_traj, u_traj, x0_, yref_, yref_e_):
        """Runs per stage-device on its chunk of stages."""
        idx = jax.lax.axis_index(STAGE_AXIS)
        k0 = idx * chunk
        x_chunk = jax.lax.dynamic_slice_in_dim(x_traj, k0, chunk + 1, 0)
        u_chunk = jax.lax.dynamic_slice_in_dim(u_traj, k0, chunk, 0)
        yref_chunk = jax.lax.dynamic_slice_in_dim(yref_, k0, chunk, 0)

        # stage-local linearization (the expensive jacfwd work)
        x_next, A, B = linearize_trajectory(
            dynamics, spec.params, x_chunk, u_chunk, spec.dt, spec.sim_steps)

        blocks = gauss_newton_cost_blocks(
            cost.W, cost.Vx, cost.Vu, cost.W_e, cost.Vx_e,
            x_chunk, u_chunk, yref_chunk, yref_e_)
        # The terminal gradient must come from the *global* trajectory end,
        # not this chunk's last state — x_traj is replicated, so every
        # device computes the identical (P, p) here.
        e_N = cost.Vx_e @ x_traj[-1] - yref_e_
        blocks["p"] = cost.Vx_e.T @ (cost.W_e @ e_N)
        qp_local = build_qp(A, B, x_next, x_chunk, u_chunk,
                            jnp.where(idx == 0, x0_, x_chunk[0]),
                            spec.lbu, spec.ubu, blocks)

        # local partial condensing of chunk/block blocks
        reduced, maps = condensing.condense(qp_local, block)
        return qp_local, reduced, maps

    def sharded_step(x_traj, u_traj, x0_, yref_, yref_e_):
        qp_local, reduced, maps = local_work(x_traj, u_traj, x0_, yref_,
                                             yref_e_)

        # gather the reduced stage problems from all stage-devices
        def gather(x):
            g = jax.lax.all_gather(x, STAGE_AXIS, axis=0)
            return g.reshape((-1,) + g.shape[2:])

        reduced_all = jax.tree.map(gather, reduced)
        # scalars/terminal entries must stay unstacked: rebuild them
        full_reduced = condensing.QPData(
            A=reduced_all.A, B=reduced_all.B, c=reduced_all.c,
            Qxx=reduced_all.Qxx, qx=reduced_all.qx,
            Ruu=reduced_all.Ruu, ru=reduced_all.ru, S=reduced_all.S,
            P=reduced.P, p=reduced.p,
            lb=reduced_all.lb, ub=reduced_all.ub,
            dx0=x0_ - x_traj[0],
        )

        sol = ipm.solve(full_reduced, config)

        # local expansion: slice this device's reduced states/inputs
        m_local = chunk // block
        idx = jax.lax.axis_index(STAGE_AXIS)
        m0 = idx * m_local
        dx_red_local = jax.lax.dynamic_slice_in_dim(
            sol.dx, m0, m_local + 1, 0)
        v_red_local = jax.lax.dynamic_slice_in_dim(sol.du, m0, m_local, 0)
        dx_loc, du_loc = condensing.expand(maps, dx_red_local, v_red_local)
        # dx_loc has chunk+1 rows; drop the overlap row except on the last
        # device by gathering the first `chunk` rows plus global terminal.
        dx_all = jax.lax.all_gather(dx_loc[:chunk], STAGE_AXIS, axis=0)
        dx_all = dx_all.reshape(-1, NX)
        dx_full = jnp.concatenate([dx_all, sol.dx[-1][None]], axis=0)
        du_all = jax.lax.all_gather(du_loc, STAGE_AXIS, axis=0)
        du_full = du_all.reshape(-1, NU)

        x_new = x_traj + dx_full
        u_new = u_traj + du_full
        res_nl = jnp.maximum(jnp.max(jnp.abs(qp_local.c)),
                             jnp.max(jnp.abs(x0_ - x_traj[0])))
        res_nl = jax.lax.pmax(res_nl, STAGE_AXIS)
        step_norm = jnp.maximum(jnp.max(jnp.abs(du_full)),
                                jnp.max(jnp.abs(dx_full)))
        return x_new, u_new, jnp.maximum(res_nl, step_norm), sol.stats["mu"]

    x_new, u_new, kkt, mu = sharded_step(state.x_traj, state.u_traj, x0,
                                         yref, yref_e)
    new_state = RTIState(x_traj=x_new, u_traj=u_new)
    out = RTIOutput(u0=u_new[0], u1=u_new[1], x_plan=x_new, u_plan=u_new,
                    kkt_res=kkt, qp_mu=mu)
    return new_state, out
