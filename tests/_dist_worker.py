"""Worker process for the multi-host (fake pod) test.

Launched by tests/test_distributed.py: N processes x 2 virtual CPU devices
each form one global JAX program (jax.distributed + Gloo CPU collectives —
the standard trick for testing multi-node without a cluster, SURVEY.md §4).
Each worker runs one pod-wide RTI step on its shard of a global swarm batch
and writes its local u0 shard to disk for the parent to reassemble.
"""

import os
import sys


def main():
    rank = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = int(sys.argv[3])
    outdir = sys.argv[4]

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    import jax

    jax.config.update("jax_platforms", "cpu")

    from crazyflie_nmpc_tpu.parallel.pod import init_distributed

    nglobal, _ = init_distributed(coordinator=f"127.0.0.1:{port}",
                                  num_processes=nproc, process_id=rank)
    assert nglobal == nproc

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from crazyflie_nmpc_tpu.models import NX, hover_state
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.parallel import make_mesh
    from crazyflie_nmpc_tpu.parallel.mesh import BATCH_AXIS
    from crazyflie_nmpc_tpu.parallel.pod import fleet_metrics, pod_rti_step
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    n_dev = len(jax.devices())            # nproc * 2 virtual devices
    mesh = make_mesh(batch=n_dev, stage=1)
    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)

    B = 2 * n_dev
    per_proc = B // nproc
    # deterministic global problem, identical on every rank
    key = jax.random.PRNGKey(42)
    x0s_np = np.asarray(
        hover_state(spec.params, dtype=jnp.float32)[None, :]
        + 0.04 * jax.random.normal(key, (B, NX), jnp.float32))
    states_np = jax.tree.map(
        np.asarray, jax.vmap(lambda x: init_rti(spec, jnp.asarray(x)))(
            jnp.asarray(x0s_np)))

    sh = NamedSharding(mesh, P(BATCH_AXIS))
    lo, hi = rank * per_proc, (rank + 1) * per_proc

    def globalize(arr):
        return jax.make_array_from_process_local_data(
            sh, np.ascontiguousarray(arr[lo:hi]), arr.shape)

    x0s = globalize(x0s_np)
    states = jax.tree.map(globalize, states_np)

    step = pod_rti_step(spec, mesh, IPMConfig(iters=6))
    new_states, outs = step(states, x0s, jnp.asarray(yref),
                            jnp.asarray(yref_e))

    # pod-wide telemetry reduction crosses the process boundary (Gloo)
    kkt_max, mu_mean = fleet_metrics(mesh)(outs.kkt_res, outs.qp_mu)

    local_rows = []
    for shard in outs.u0.addressable_shards:
        local_rows.append((shard.index[0].start or 0, np.asarray(shard.data)))
    local_rows.sort(key=lambda t: t[0])
    u0_local = np.concatenate([r for _, r in local_rows], axis=0)
    np.save(os.path.join(outdir, f"u0_rank{rank}.npy"), u0_local)
    np.save(os.path.join(outdir, f"kkt_rank{rank}.npy"),
            np.array([float(kkt_max), float(mu_mean)]))
    print(f"rank {rank}: OK devices={n_dev} u0_local={u0_local.shape}",
          flush=True)

    # ---- phase 2: STAGE axis across the process boundary --------------
    # The horizon's all_gather of condensed QP blocks
    # (parallel/sharded.py:112) rides the cross-process (Gloo, i.e. the
    # DCN stand-in) collective here: mesh = (batch=1, stage=all devices),
    # with each PROCESS owning half the stage devices.  This is the
    # reference's HPIPM Riccati structure crossing hosts (SURVEY.md §2.6).
    from jax import shard_map
    from crazyflie_nmpc_tpu.parallel import stage_sharded_rti_step
    from crazyflie_nmpc_tpu.parallel.mesh import STAGE_AXIS

    jax.config.update("jax_enable_x64", True)
    spec_s = default_ocp(N=8, dtype=jnp.float64)
    yref_s, yref_e_s = hover_yref(spec_s)
    mesh_s = make_mesh(batch=1, stage=n_dev)
    x0_s = np.asarray(hover_state(spec_s.params, pos=(0.1, -0.05, 0.3)))
    state_s = init_rti(spec_s, jnp.asarray(x0_s))

    rep = NamedSharding(mesh_s, P())   # replicated: full array per process

    def replicate(a):
        a = np.asarray(a)
        return jax.make_array_from_process_local_data(rep, a, a.shape)

    state_g = jax.tree.map(replicate, state_s)
    args_g = tuple(replicate(a) for a in (x0_s, yref_s, yref_e_s))

    fn = shard_map(
        lambda s, x, yr, ye: stage_sharded_rti_step(
            spec_s, mesh_s, 2, s, x, yr, ye, IPMConfig(iters=10)),
        mesh=mesh_s,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    new_state_s, out_s = jax.jit(fn)(state_g, *args_g)
    # output is replicated: any local shard holds the full array
    u_traj = np.asarray(new_state_s.u_traj.addressable_shards[0].data)
    np.save(os.path.join(outdir, f"stage_u_rank{rank}.npy"), u_traj)
    print(f"rank {rank}: stage-axis OK u_traj={u_traj.shape}", flush=True)


if __name__ == "__main__":
    main()
