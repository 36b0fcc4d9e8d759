"""Monte-Carlo robustness study: 1k perturbed hover scenarios in lockstep.

BASELINE.json config 3 as a runnable example: the whole batch of closed
loops is ONE jit'd scan whose per-tick controller is the batched RTI
step (every scenario = one lane of the batch-last solver).  It runs on
the default device; --cpu pins the CPU backend.

    python examples/monte_carlo.py [--batch 64] [--steps 200] [--cpu]

Prints convergence statistics and writes a flight bag of the worst
scenario for inspection with `python -m crazyflie_nmpc_tpu.tools bag`.
"""

import argparse
import sys

sys.path.insert(0, ".")

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pos-scale", type=float, default=0.3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of the default "
                         "device")
    ap.add_argument("--bag", default="/tmp/mc_worst.bag")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.runtime.bag import BagWriter
    from crazyflie_nmpc_tpu.runtime.batch import monte_carlo_hover
    from crazyflie_nmpc_tpu.solver import default_ocp

    spec = default_ocp(dtype=jnp.float32)
    res = monte_carlo_hover(
        spec, jax.random.PRNGKey(0), batch=args.batch, steps=args.steps,
        pos_scale=args.pos_scale, config=IPMConfig(iters=8))

    x = np.asarray(res.x)                      # (T, B, 13)
    setpoint = np.array([0.0, 0.0, 0.5])
    final_err = np.linalg.norm(x[-1, :, :3] - setpoint, axis=-1)
    print(f"scenarios: {args.batch}, steps: {args.steps} "
          f"({args.steps * float(spec.dt):.1f} s)")
    print(f"final position error: mean {final_err.mean():.2e} m, "
          f"p95 {np.percentile(final_err, 95):.2e} m, "
          f"max {final_err.max():.2e} m")
    print(f"max |KKT| anywhere: {float(np.max(np.asarray(res.kkt_res))):.2e}")
    conv = float((final_err < 1e-2).mean())
    print(f"converged (<1 cm): {100 * conv:.1f}%")

    worst = int(np.argmax(final_err))
    ts = float(spec.dt) * np.arange(args.steps)
    with BagWriter(args.bag) as w:
        w.write_series("state_estimate", ts, x[:, worst])
        w.write_series("motvel", ts, np.asarray(res.u)[:, worst])
        w.write_series("kkt_res", ts, np.asarray(res.kkt_res)[:, worst])
    print(f"worst scenario (#{worst}, err {final_err[worst]:.2e} m) "
          f"recorded to {args.bag}")


if __name__ == "__main__":
    main()
