"""End-to-end demo: NMPC closed loop over the native CRTP/UDP link.

The full reference pipeline, software-only (SURVEY.md section 3.1-3.3):

    simulated plant (ERK4 of the same model)     <- "the drone"
      -> mocap position + attitude + gyro        (sensor synthesis)
      -> estimator fuse + delay predictor        (estimator.pipeline)
      -> RTI NMPC solve                          (solver.rti)
      -> u1/x4 -> cmd_vel conversion             (solver.outputs)
      -> native link server -> CRTP bytes -> UDP (native.LinkServer)
      -> fake drone endpoint decodes the setpoint packet

plus the kRPM command loopback into the estimator (acados_motvel).
Prints tracking error and link statistics.  Run:  python examples/closed_loop_udp.py
"""

import socket
import sys
import time

sys.path.insert(0, ".")

import jax

# Protocol/pipeline demo with a per-tick host loop: run on CPU (the
# accelerator path is for batched solves, not single-tick host round-trips).
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from crazyflie_nmpc_tpu import native
from crazyflie_nmpc_tpu.estimator import (
    estimate,
    init_estimator,
    notify_command,
)
from crazyflie_nmpc_tpu.models import dynamics, hover_state, rotations
from crazyflie_nmpc_tpu.ops.integrators import rk4_step
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu.solver import (
    default_ocp,
    hover_yref,
    init_rti,
    rti_step,
    to_cmd_vel,
)


def main(steps=200, setpoint=(0.0, 0.0, 0.5)):
    spec = default_ocp(dtype=jnp.float32)
    cfg = IPMConfig(iters=8)
    yref, yref_e = hover_yref(spec, pos=setpoint)
    dt = float(spec.dt)
    delay = 0.0  # single-process demo: no radio latency to compensate

    # fake drone endpoint (the far side of the radio)
    drone_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    drone_sock.bind(("127.0.0.1", 48001))
    drone_sock.settimeout(0.5)

    step = jax.jit(lambda s, x: rti_step(spec, s, x, yref, yref_e, cfg))

    x = hover_state(spec.params, pos=(0.25, -0.15, 0.2), dtype=jnp.float32)
    est = init_estimator(spec.params, x[0:3])
    rti = init_rti(spec, x)

    received = []
    with native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", 48001, 48002)
        # drain the thrust-lock-release burst
        t_end = time.time() + 1.0
        while time.time() < t_end:
            try:
                drone_sock.recvfrom(64)
            except socket.timeout:
                break

        for k in range(steps):
            # sensor synthesis from the true plant state
            rpy = rotations.quat_to_euler(x[3:7])
            est, x_hat = estimate(spec.params, est, x[0:3], rpy, x[10:13],
                                  dt, delay, sim_steps=1)
            rti, out = step(rti, x_hat)
            est = notify_command(est, out.u0)

            # cmd_vel conversion + CRTP transmission
            cmd = to_cmd_vel(out.u1, out.x_at(4))
            server.send_setpoint(1, float(cmd.roll_deg),
                                 float(cmd.pitch_deg),
                                 float(cmd.yawrate_deg),
                                 int(cmd.thrust_pwm))
            # the "drone" drains the link (keep-alive pings arrive at
            # ~1 kHz; pick out the commander setpoints)
            drone_sock.setblocking(False)
            try:
                while True:
                    raw, _ = drone_sock.recvfrom(64)
                    try:
                        received.append(native.decode_setpoint(raw))
                    except ValueError:
                        pass  # pings etc.
            except BlockingIOError:
                pass
            drone_sock.settimeout(0.5)

            # plant: apply the *solver* controls (rotor-speed actuation, as
            # the estimator/plant pair defines the closed loop)
            x = rk4_step(dynamics, spec.params, x, out.u0, dt)

        err = np.abs(np.asarray(x[0:3]) - np.asarray(setpoint))
        stats = server.stats(1)

    drone_sock.close()
    print(f"final position error: {err}")
    print(f"decoded setpoint packets at the drone: {len(received)}")
    if received:
        r, p, yrate, t = received[-1]
        print(f"last packet: roll={r:.3f} deg pitch={p:.3f} deg "
              f"yawrate={yrate:.3f} deg/s thrust={t} PWM")
    print(f"link stats: {stats}")
    assert err.max() < 5e-3, "closed loop did not converge"
    assert len(received) > steps // 2, "link dropped too many packets"
    print("OK")


if __name__ == "__main__":
    main()
