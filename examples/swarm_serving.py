"""The multi-drone server as ONE batched solve — runnable example.

The reference runs one NMPC node per Crazyflie behind a per-drone-thread
server (crazyflie_server.cpp:155,1108-1131; multi_hover_*.launch).  Here
the vehicle axis IS the batch axis: N cascade-plant firmware endpoints
behind the native link, a single `rti_step_batched` launch per tick with
per-vehicle formation references, telemetry returning into a batched
estimator, per-vehicle cmd_vel + deadline accounting.

    python examples/swarm_serving.py [--n 8] [--ticks 220] [--realtime]

Lockstep (default) is deterministic and sleep-free; --realtime runs the
endpoints' serve threads against the absolute-time TickScheduler.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=220)
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--rate", type=float, default=66.6)
    args = ap.parse_args()

    from crazyflie_nmpc_tpu import bringup

    out = bringup.swarm_serving(n=args.n, ticks=args.ticks,
                                rate_hz=args.rate,
                                lockstep=not args.realtime)
    rep = out["report"]
    print(f"\n{args.n} vehicles x {args.ticks} ticks "
          f"({'realtime' if args.realtime else 'lockstep'} @ "
          f"{args.rate:.1f} Hz):")
    for k, v in out["summary"].items():
        print(f"  {k}: {v}")
    err = np.round(rep.final_err_m, 4)
    print(f"  per-vehicle final |pos - target| [m]: {err.tolist()}")
    misses = rep.deadline_misses(budget_s=rep.period_s)
    print(f"  per-vehicle deadline misses (budget = one period): "
          f"{misses.tolist()}")


if __name__ == "__main__":
    main()
