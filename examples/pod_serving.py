"""Pod-scale NMPC serving skeleton: shard a swarm over a device mesh.

BASELINE.json config 5 as a runnable example.  It runs across every
visible device (and across hosts after `parallel.pod.init_distributed()`);
on a development machine run it on a virtual CPU device mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/pod_serving.py --ticks 3 --cpu

Structure (the batched replacement for the reference's one-thread-per-
drone radio server, crazyflie_server.cpp:1108):
  * the swarm is ONE global batch, sharded over the mesh's batch axis,
  * each device advances its shard with the batched RTI step —
    no collectives in the solve,
  * fleet telemetry (worst KKT residual, mean QP gap) reduces across the
    pod with psum-family collectives (`parallel.pod.fleet_metrics`).
"""

import argparse
import sys

sys.path.insert(0, ".")

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--per-device", type=int, default=4,
                    help="vehicles per device")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the default "
                         "device")
    args = ap.parse_args()

    # decide the platform BEFORE any backend query: the first use pins it
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from crazyflie_nmpc_tpu.models import NX, hover_state
    from crazyflie_nmpc_tpu.ops.backend import sweep_backend
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.parallel import make_mesh
    from crazyflie_nmpc_tpu.parallel.pod import fleet_metrics, pod_rti_step
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    n_dev = len(jax.devices())
    mesh = make_mesh(batch=n_dev, stage=1)
    on_acc = sweep_backend() == "kernel"
    B = args.per_device * n_dev
    print(f"devices: {n_dev} ({jax.devices()[0].platform}), swarm: {B}")

    spec = default_ocp(N=50 if on_acc else 10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    key = jax.random.PRNGKey(0)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.05 * jax.random.normal(key, (B, NX), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)

    step = pod_rti_step(spec, mesh, IPMConfig(iters=8))
    metrics = fleet_metrics(mesh)

    for t in range(args.ticks):
        states, outs = step(states, x0s, yref, yref_e)
        kkt_max, mu_mean = metrics(outs.kkt_res, outs.qp_mu)
        print(f"tick {t}: fleet max|KKT| {float(kkt_max):.3e}, "
              f"mean qp gap {float(mu_mean):.3e}")

    u0 = np.asarray(outs.u0)
    print(f"u0 range across fleet: [{u0.min():.3f}, {u0.max():.3f}] kRPM "
          f"(hover ~{float(spec.params.hover_speed()):.2f})")


if __name__ == "__main__":
    main()
