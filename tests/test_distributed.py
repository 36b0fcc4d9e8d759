"""Multi-host (multi-PROCESS) pod test: 2 processes x 2 virtual CPU devices
form one 4-device global mesh via jax.distributed + Gloo CPU collectives —
faking a pod without a cluster (SURVEY.md §4's multi-host test strategy).

The in-process suite (test_sharding.py) covers the single-controller
virtual-mesh path; this covers the genuinely multi-controller one: global
array construction from process-local shards, a pod-wide RTI step, and a
cross-process fleet-metric reduction.  The result is compared against the
same step computed unsharded in this (single) process.
"""

import os
import subprocess
import sys

import numpy as np

NPROC = 2
PORT = 49871


def test_two_process_pod_step(tmp_path):
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count (2)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    workers = []
    for rank in range(NPROC):
        workers.append(subprocess.Popen(
            [sys.executable, os.path.join(os.path.dirname(__file__),
                                          "_dist_worker.py"),
             str(rank), str(NPROC), str(PORT), str(tmp_path)],
            env=env, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for w in workers:
        out, _ = w.communicate(timeout=560)
        outs.append(out)
    for rank, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"

    u0 = np.concatenate(
        [np.load(tmp_path / f"u0_rank{r}.npy") for r in range(NPROC)],
        axis=0)

    # reference: the identical problem solved unsharded in-process
    import jax
    import jax.numpy as jnp

    from crazyflie_nmpc_tpu.models import NX, hover_state
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=10, dtype=jnp.float32)
    yref, yref_e = hover_yref(spec)
    B = u0.shape[0]
    key = jax.random.PRNGKey(42)
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.04 * jax.random.normal(key, (B, NX), jnp.float32))
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    _, ref = rti_step_batched(spec, states, x0s, yref, yref_e,
                              IPMConfig(iters=6))
    np.testing.assert_allclose(u0, np.asarray(ref.u0), rtol=2e-3, atol=2e-3)

    # both ranks agree on the pod-wide reduced metrics (one Gloo all-reduce)
    k0 = np.load(tmp_path / "kkt_rank0.npy")
    k1 = np.load(tmp_path / "kkt_rank1.npy")
    np.testing.assert_allclose(k0, k1, rtol=1e-6)

    # ---- stage axis across processes (phase 2 of the worker) ----------
    # The condensed-block all_gather (parallel/sharded.py:112) crossed the
    # Gloo process boundary; compare against the unsharded RTI step.
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import rti_step

    # conftest enables x64 suite-wide; re-assert locally without leaking a
    # changed value into later tests if that ever changes (ADVICE r2)
    assert jax.config.read("jax_enable_x64"), (
        "suite conftest is expected to enable x64")
    spec_s = default_ocp(N=8, dtype=jnp.float64)
    yref_s, yref_e_s = hover_yref(spec_s)
    x0_s = hover_state(spec_s.params, pos=(0.1, -0.05, 0.3))
    state_s = init_rti(spec_s, x0_s)
    _, ref_out = jax.jit(lambda s, x: rti_step(
        spec_s, s, x, yref_s, yref_e_s, IPMConfig(iters=10)))(state_s, x0_s)

    for r in range(NPROC):
        u_traj = np.load(tmp_path / f"stage_u_rank{r}.npy")
        np.testing.assert_allclose(u_traj, np.asarray(ref_out.u_plan),
                                   rtol=1e-8, atol=1e-9)
