"""Pod-scale serving: the batched RTI path sharded over device meshes.

BASELINE.json config 5 ("100k+ scenarios sharded across N>=2 hosts"): the
batch axis is embarrassingly parallel, so the pod path is `shard_map` over
the mesh's batch axis with each device running the batched RTI step
(`solver.rti_step_batched`) on its local shard — nothing crosses devices
during a solve, and only user-requested metric reductions
(`psum`/`pmax`) communicate.  Multi-host runs initialize with
`init_distributed()` (jax.distributed) and shard the global batch over
(hosts x devices); the network never sees solver state.

The horizon axis composes on top via `sharded.stage_sharded_rti_step`
(collective-reduced partial condensing over STAGE_AXIS) — the two axes are
the same mesh's dimensions (parallel.mesh.make_mesh).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.parallel.mesh import BATCH_AXIS
from crazyflie_nmpc_tpu.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize multi-host JAX (jax.distributed) if not already done.

    Pass all three arguments: nothing in the environment describes the
    cluster (on a CPU fake cluster this is the standard XLA trick for
    testing multi-node without a cluster, SURVEY.md §4).
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized
    return jax.process_count(), jax.process_index()


def pod_rti_step(spec: OCPSpec, mesh,
                 config: ipm.IPMConfig = ipm.IPMConfig(),
                 condense: int | None = None):
    """Jitted pod-wide batched RTI step.

    Returns fn(states, x0s, yref, yref_e) -> (states', outs).  Batch-first
    global arrays, sharded over the mesh's batch axis; yref/yref_e are
    replicated (shared reference) or batch-sharded (per-problem).  Each
    device solves its local shard; no collectives in the solve itself.

    condense defaults to block-2 partial condensing when the horizon is
    even.
    """
    from jax import shard_map

    if condense is None:
        condense = 2 if spec.N % 2 == 0 else 1

    def local_step(states, x0s, yref, yref_e):
        new_states, outs = rti_step_batched(
            spec, states, x0s, yref, yref_e, config, condense=condense)
        return new_states, outs

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P(), P()),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )

    batch_sharding = NamedSharding(mesh, P(BATCH_AXIS))

    @jax.jit
    def step(states, x0s, yref, yref_e):
        states = jax.lax.with_sharding_constraint(states, batch_sharding)
        return sharded(states, x0s, yref, yref_e)

    return step


def fleet_metrics(mesh):
    """Pod-wide telemetry reduction: worst KKT residual and mean QP gap
    across all shards (the 'solver-status surfaced per batch element'
    plane of SURVEY.md §5, reduced for dashboards)."""
    from jax import shard_map

    def local(kkt, mu):
        return (jax.lax.pmax(jnp.max(kkt), BATCH_AXIS),
                jax.lax.pmean(jnp.mean(mu), BATCH_AXIS))

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    ))
