"""MissionClient, checkpoint/resume, sysid, failure guard, swarm runtime."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crazyflie_nmpc_tpu.estimator import sysid
from crazyflie_nmpc_tpu.models import NX, QuadrotorParams, hover_state
from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.runtime.batch import monte_carlo_hover
from crazyflie_nmpc_tpu.runtime.client import MissionClient
from crazyflie_nmpc_tpu.solver import (
    default_ocp,
    init_rti,
    rti_step,
)
from crazyflie_nmpc_tpu.solver import policies as pol
from crazyflie_nmpc_tpu.utils import load_poly_csv
from crazyflie_nmpc_tpu.utils.checkpoint import load_state, save_state

CFG = ipm.IPMConfig(iters=8)


def spec32(N=20):
    return default_ocp(N=N, dtype=jnp.float32)


# ---------------- MissionClient -----------------------------------------

def test_client_takeoff_flies_closed_loop():
    """takeoff -> tick-driven closed loop reaches the target height."""
    spec = spec32()
    client = MissionClient(spec)
    client.takeoff(height=0.5, duration=1.5, at=(0.0, 0.0, 0.0))
    assert client.mode == pol.TRACKING

    from crazyflie_nmpc_tpu.models import dynamics
    from crazyflie_nmpc_tpu.ops.integrators import rk4_step

    x = hover_state(spec.params, pos=(0.0, 0.0, 0.04), dtype=jnp.float32)
    state = init_rti(spec, x)
    step = jax.jit(lambda s, x, yr, ye: rti_step(spec, s, x, yr, ye, CFG))
    plant = jax.jit(lambda x, u: rk4_step(dynamics, spec.params, x, u,
                                          spec.dt))
    for _ in range(160):  # 2.4 s
        yref, yref_e = client.tick()
        state, out = step(state, x, yref, yref_e)
        x = plant(x, out.u0)
    assert abs(float(x[2]) - 0.5) < 0.02
    assert client.done  # trajectory consumed -> Position_Hold


def test_client_goto_and_upload():
    spec = spec32()
    client = MissionClient(spec)
    client.go_to((0.5, 0.5, 0.8), from_pos=(0, 0, 0.5), duration=2.0)
    yref, yref_e = client.tick()
    np.testing.assert_allclose(np.asarray(yref[0, :3]), [0, 0, 0.5],
                               atol=1e-5)
    # uploaded polynomial trajectory (reference figure8.csv)
    durations, coeffs = load_poly_csv(
        "/root/reference/crazyflie_demo/scripts/figure8.csv")
    client.upload_trajectory(7, durations, coeffs)
    client.start_trajectory(7)
    yref, _ = client.tick()
    assert np.all(np.isfinite(np.asarray(yref)))
    client.stop()
    assert client.mode == pol.REGULATION


# ---------------- checkpoint / resume ------------------------------------

def test_checkpoint_roundtrip_exact_resume():
    """Saving and restoring RTIState mid-flight resumes bit-exactly."""
    spec = spec32(N=10)
    x0 = hover_state(spec.params, pos=(0.2, 0.0, 0.3), dtype=jnp.float32)
    from crazyflie_nmpc_tpu.solver import hover_yref
    yref, yref_e = hover_yref(spec)
    state = init_rti(spec, x0)
    step = jax.jit(lambda s: rti_step(spec, s, x0, yref, yref_e, CFG))
    for _ in range(3):
        state, _ = step(state)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_state(path, state)
        restored = load_state(path, init_rti(spec, x0))

    s1, o1 = rti_step(spec, state, x0, yref, yref_e, CFG)
    s2, o2 = rti_step(spec, restored, x0, yref, yref_e, CFG)
    np.testing.assert_array_equal(np.asarray(o1.u0), np.asarray(o2.u0))
    np.testing.assert_array_equal(np.asarray(s1.u_traj),
                                  np.asarray(s2.u_traj))


# ---------------- sysid ---------------------------------------------------

def test_fit_thrust_map_recovers_reference_line():
    rng = np.random.default_rng(0)
    pwm = rng.uniform(10000, 60000, 200)
    krpm = (pwm * 0.2685 + 4070.3) / 1000.0
    a, b = sysid.fit_thrust_map(krpm, pwm)
    assert abs(a - 0.2685) < 1e-9
    assert abs(b - 4070.3) < 1e-6


def test_fit_thrust_coefficient():
    params = QuadrotorParams()
    ct = sysid.fit_thrust_coefficient(params, [15.7777, 15.7778, 15.7776])
    assert abs(ct - 3.25e-4) / 3.25e-4 < 1e-3


def test_assemble_measurements_matches_estimator_fuse():
    from crazyflie_nmpc_tpu.estimator import fuse, init_estimator
    from crazyflie_nmpc_tpu.models import rotations

    params = QuadrotorParams()
    rng = np.random.default_rng(1)
    T = 30
    positions = np.cumsum(0.01 * rng.standard_normal((T, 3)), axis=0)
    eulers = 0.1 * rng.standard_normal((T, 3))
    gyros = 0.2 * rng.standard_normal((T, 3))
    stream = sysid.assemble_measurements(positions, eulers, gyros, 0.015)
    est = init_estimator(params, jnp.asarray(positions[0]))
    for k in range(T):
        est, xk = fuse(est, jnp.asarray(positions[k]),
                       jnp.asarray(eulers[k]), jnp.asarray(gyros[k]), 0.015)
        np.testing.assert_allclose(np.asarray(stream[k]), np.asarray(xk),
                                   rtol=1e-5, atol=1e-6)


def test_fit_drag_coefficient():
    params = QuadrotorParams()
    rng = np.random.default_rng(2)
    u = 15.0 + rng.uniform(-2, 2, (100, 4))
    mix = u[:, 0] ** 2 - u[:, 1] ** 2 + u[:, 2] ** 2 - u[:, 3] ** 2
    dwz = -float(params.Cd) * mix / float(params.Izz)
    cd = sysid.fit_drag_coefficient(params, u, dwz)
    assert abs(cd - float(params.Cd)) / float(params.Cd) < 1e-6


# ---------------- failure guard ------------------------------------------

def test_hold_last_action_on_failure():
    """Poison the reference mid-flight (NaN setpoint) and verify the loop
    holds the last finite command instead of propagating NaN."""
    from crazyflie_nmpc_tpu.runtime import LoopConfig, simulate

    spec = spec32(N=10)
    x0 = hover_state(spec.params, pos=(0.0, 0.0, 0.5), dtype=jnp.float32)
    # trajectory table with NaNs from row 30 on: Tracking hits the poison
    table = np.tile(np.concatenate([np.asarray(x0),
                                    np.full(4, 15.7777)]), (60, 1))
    table[30:, 2] = np.nan
    pol_state = pol.tracking_state()
    res = simulate(spec, x0, pol_state, jnp.asarray(table, jnp.float32),
                   steps=40, config=LoopConfig(ipm=CFG))
    u = np.asarray(res.u)
    # commands stay finite throughout thanks to the guard
    assert np.all(np.isfinite(u)), "guard failed to hold last action"
    assert np.all(np.isfinite(np.asarray(res.x)))


# ---------------- swarm (reduced size) -----------------

def test_monte_carlo_swarm_runtime():
    # N=20+ and iters=8 is the production envelope; shorter horizons with
    # starved iteration budgets can self-degrade their warm starts on
    # aggressive transients (documented in solver/rti.py).
    spec = spec32(N=20)
    res = monte_carlo_hover(spec, jax.random.PRNGKey(0), batch=8,
                            steps=150, config=ipm.IPMConfig(iters=8))
    assert res.x.shape == (150, 8, NX)
    final = np.asarray(res.x[-1, :, :3])
    assert np.abs(final - np.array([0, 0, 0.5])).max() < 0.02
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_imu_echo_tool(capsys):
    """tools imu attaches, starts a log block, and prints decoded samples
    (crazyflie_imu.cpp equivalent)."""
    import pytest

    native = pytest.importorskip("crazyflie_nmpc_tpu.native")
    del native
    from crazyflie_nmpc_tpu.native import FirmwareSim
    from crazyflie_nmpc_tpu.tools import main

    state = {"gyro.x": 1.0, "gyro.y": 2.0, "gyro.z": 3.0,
             "acc.x": 0.0, "acc.y": 0.0, "acc.z": 1.0}
    with FirmwareSim(47041,
                     state_provider=lambda n: state.get(n, 0.0)).serve():
        rc = main(["imu", "--peer-port", "47041", "--local-port", "47042",
                   "--duration", "1.0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "gyro [deg/s]" in out
    assert "+1.000" in out and "+3.000" in out


# ---------------- determinism / debug plane --------------------------------

def test_closed_loop_deterministic_replay():
    """Same inputs -> bitwise-identical closed-loop trajectories (the
    functional-purity replacement for the reference's benign races,
    SURVEY.md section 5)."""
    from crazyflie_nmpc_tpu.runtime import LoopConfig, hover_regulation
    from crazyflie_nmpc_tpu.utils.debug import assert_deterministic

    spec = spec32(N=10)
    x0 = hover_state(spec.params, pos=(0.2, -0.1, 0.3), dtype=jnp.float32)

    def run():
        res = hover_regulation(spec, x0, steps=30,
                               config=LoopConfig(ipm=CFG))
        return res.x, res.u
    assert_deterministic(run)


def test_check_finite_and_fallback():
    from crazyflie_nmpc_tpu.utils.debug import (
        check_finite,
        finite_or_fallback,
    )

    good = {"a": jnp.ones(3), "b": jnp.zeros((2, 2))}
    check_finite(good)  # no raise
    bad = {"a": jnp.array([1.0, jnp.nan]), "b": jnp.zeros(2)}
    with pytest.raises(FloatingPointError, match="a"):
        check_finite(bad, where="test")

    fb = {"a": jnp.zeros(2), "b": jnp.ones(2)}
    out = finite_or_fallback(bad, fb)
    np.testing.assert_array_equal(np.asarray(out["a"]), [0.0, 0.0])
    out2 = finite_or_fallback({"a": jnp.ones(2), "b": jnp.ones(2)}, fb)
    np.testing.assert_array_equal(np.asarray(out2["a"]), [1.0, 1.0])


def test_toc_tool(capsys):
    """tools toc lists the param/log tables (crazyflie_tools parity)."""
    native = pytest.importorskip("crazyflie_nmpc_tpu.native")
    del native
    from crazyflie_nmpc_tpu.native import FirmwareSim
    from crazyflie_nmpc_tpu.tools import main

    with FirmwareSim(47043).serve():
        rc = main(["toc", "--peer-port", "47043", "--local-port", "47044"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "commander/enHighLevel" in out and "uint8" in out
    assert "gyro.x" in out and "float" in out


def test_profiler_trace_capture(tmp_path):
    """utils.profiling: a device trace is captured with named phases
    (the reference's per-solve timing plane, SURVEY §5, on the XLA
    profiler instead of rosbag/rqt_plot)."""
    import jax
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.utils import profiling

    d = str(tmp_path / "trace")

    @jax.jit
    def f(x):
        with profiling.phase("test-phase"):
            return (x @ x).sum()

    with profiling.trace(d):
        out = f(jnp.ones((64, 64)))
        jax.block_until_ready(out)
    files = profiling.trace_files(d)
    assert files, f"no trace artifacts under {d}"


def test_persistent_cache_disabled_context():
    """utils.cache.persistent_cache_disabled: compiles inside the context
    skip the persistent cache (CPU-pinned executables in mixed-backend
    processes must not touch the flaky XLA:CPU AOT loader — see
    utils/cache.py), and the flag is restored even on error."""
    from crazyflie_nmpc_tpu.utils.cache import persistent_cache_disabled

    prev = bool(jax.config.jax_enable_compilation_cache)
    with persistent_cache_disabled():
        assert not jax.config.jax_enable_compilation_cache
        # a compile inside the context works and stays process-local
        assert float(jax.jit(lambda x: x + 1.0)(jnp.float32(1.0))) == 2.0
    assert bool(jax.config.jax_enable_compilation_cache) == prev

    with pytest.raises(RuntimeError):
        with persistent_cache_disabled():
            raise RuntimeError("boom")
    assert bool(jax.config.jax_enable_compilation_cache) == prev
