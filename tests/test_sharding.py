"""Multi-device sharding tests on the virtual 8-CPU-device mesh."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from crazyflie_nmpc_tpu.models import NX, NU, hover_state
from crazyflie_nmpc_tpu.ops import ipm
from crazyflie_nmpc_tpu.parallel import (
    BATCH_AXIS,
    STAGE_AXIS,
    batch_sharded_rti,
    make_mesh,
    stage_sharded_rti_step,
)
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti, rti_step

CFG = ipm.IPMConfig(iters=10)


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_batch_sharded_rti_matches_local():
    spec = default_ocp(N=8, dtype=jnp.float64)
    mesh = make_mesh(batch=8, stage=1)
    yref, yref_e = hover_yref(spec)
    B = 16
    key = jax.random.PRNGKey(0)
    x0s = jnp.stack([
        hover_state(spec.params) + 0.05 * jax.random.normal(
            jax.random.fold_in(key, i), (NX,)) for i in range(B)])
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    yrefs = jnp.broadcast_to(yref, (B,) + yref.shape)
    yref_es = jnp.broadcast_to(yref_e, (B,) + yref_e.shape)

    step = batch_sharded_rti(spec, mesh, CFG)
    new_states, outs = step(states, x0s, yrefs, yref_es)

    # reference: per-element local solve (jitted: eager per-primitive
    # dispatch intermittently segfaults this jaxlib's XLA:CPU compiler)
    ref_step = jax.jit(lambda s, x: rti_step(spec, s, x, yref, yref_e, CFG))
    for i in range(0, B, 5):
        si = jax.tree.map(lambda a: a[i], states)
        _, oi = ref_step(si, x0s[i])
        np.testing.assert_allclose(np.asarray(outs.u0[i]),
                                   np.asarray(oi.u0), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n_stage,block", [(2, 2), (4, 2)])
def test_stage_sharded_rti_matches_local(n_stage, block):
    """Stage-sharded condensed RTI step == plain single-device RTI step."""
    from jax import shard_map

    spec = default_ocp(N=8, dtype=jnp.float64)
    mesh = make_mesh(batch=1, stage=n_stage)
    x0 = hover_state(spec.params, pos=(0.1, -0.05, 0.3))
    yref, yref_e = hover_yref(spec)
    state = init_rti(spec, x0)

    fn = shard_map(
        lambda s, x, yr, ye: stage_sharded_rti_step(
            spec, mesh, block, s, x, yr, ye, CFG),
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    new_state, out = jax.jit(fn)(state, x0, yref, yref_e)

    ref_state, ref_out = jax.jit(
        lambda s, x: rti_step(spec, s, x, yref, yref_e, CFG))(state, x0)
    np.testing.assert_allclose(np.asarray(new_state.u_traj),
                               np.asarray(ref_state.u_traj),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(new_state.x_traj),
                               np.asarray(ref_state.x_traj),
                               rtol=1e-8, atol=1e-9)


def test_pod_rti_step_fused_path_matches_local():
    """Pod serving path: shard_map over the batch axis with the batched
    RTI step per device == the unsharded batched step."""
    from crazyflie_nmpc_tpu.parallel.pod import fleet_metrics, pod_rti_step
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=10, dtype=jnp.float32)
    mesh = make_mesh(batch=8, stage=1)
    yref, yref_e = hover_yref(spec)
    B = 16
    key = jax.random.PRNGKey(5)
    x0s = jnp.stack([
        hover_state(spec.params, dtype=jnp.float32)
        + 0.05 * jax.random.normal(jax.random.fold_in(key, i), (NX,),
                                   jnp.float32) for i in range(B)])
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)

    step = pod_rti_step(spec, mesh, CFG)
    new_states, outs = step(states, x0s, yref, yref_e)

    ref_states, ref_outs = rti_step_batched(
        spec, states, x0s, yref, yref_e, CFG)
    # f32 + different XLA fusion orders (shard_map vs plain) -> ~1e-4
    # relative noise, amplified by the IPM's conditioning near active bounds
    np.testing.assert_allclose(np.asarray(outs.u0), np.asarray(ref_outs.u0),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(new_states.u_traj),
                               np.asarray(ref_states.u_traj),
                               rtol=1e-3, atol=5e-3)

    # pod-wide metric reduction
    kkt_max, mu_mean = fleet_metrics(mesh)(outs.kkt_res, outs.qp_mu)
    assert float(kkt_max) == pytest.approx(
        float(np.max(np.asarray(outs.kkt_res))), rel=1e-6)


def test_stage_sharded_long_horizon_past_fused_envelope():
    """At N=400 the stage-sharded path (the horizon split over 4 stage
    devices) must agree with the plain single-device RTI step."""
    from jax import shard_map

    spec = default_ocp(N=400, tf=6.0, dtype=jnp.float64)
    mesh = make_mesh(batch=1, stage=4)
    x0 = hover_state(spec.params, pos=(0.2, -0.1, 0.4))
    yref, yref_e = hover_yref(spec)
    state = init_rti(spec, x0)

    fn = shard_map(
        lambda s, x, yr, ye: stage_sharded_rti_step(
            spec, mesh, 10, s, x, yr, ye, CFG),
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    new_state, out = jax.jit(fn)(state, x0, yref, yref_e)
    ref_state, _ = jax.jit(
        lambda s, x: rti_step(spec, s, x, yref, yref_e, CFG))(state, x0)
    np.testing.assert_allclose(np.asarray(new_state.u_traj),
                               np.asarray(ref_state.u_traj),
                               rtol=1e-7, atol=1e-8)


def test_stage_sharded_composes_with_windowed_long_horizon():
    """The two long-horizon mechanisms — the stage-SHARDED XLA path
    (horizon split over 4 stage devices with all_gather reduction) and
    the single-device batched step (block-2 condensing, batch-last
    sweeps, whose gains live in device memory at any N) — must produce
    the same RTI step at N=800: both express the identical Riccati
    algebra."""
    from jax import shard_map

    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    N = 800
    spec = default_ocp(N=N, tf=12.0, dtype=jnp.float32)
    cfg = ipm.IPMConfig(iters=2)
    yref, yref_e = hover_yref(spec)
    x0 = hover_state(spec.params, pos=(0.2, -0.1, 0.4), dtype=jnp.float32)
    state = init_rti(spec, x0)

    mesh = make_mesh(batch=1, stage=4)
    fn = shard_map(
        lambda s, x, yr, ye: stage_sharded_rti_step(
            spec, mesh, 10, s, x, yr, ye, cfg),
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    sharded_state, _ = jax.jit(fn)(state, x0, yref, yref_e)

    states_b = jax.tree.map(lambda a: a[None], state)
    win_state, _ = rti_step_batched(
        spec, states_b, x0[None], yref[None], yref_e[None], cfg,
        condense=2)

    du = np.abs(np.asarray(win_state.u_traj[0])
                - np.asarray(sharded_state.u_traj))
    assert du.max() < 5e-4, du.max()   # two f32 algebra orders
    dx = np.abs(np.asarray(win_state.x_traj[0])
                - np.asarray(sharded_state.x_traj))
    assert dx.max() < 5e-4, dx.max()


@pytest.mark.gpu
def test_pod_fused_production_depth(gpu_devices):
    """The PRODUCTION point — N=50, iters=8, the sweep kernel, every card
    of the host as one batch mesh — with a parity assertion against the
    unsharded batched step.  Runs on a GPU host only (`pytest -m gpu`)."""
    from crazyflie_nmpc_tpu.parallel.pod import pod_rti_step
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=50, dtype=jnp.float32)
    cfg = ipm.IPMConfig(iters=8)
    n = len(gpu_devices)
    mesh = make_mesh(batch=n, stage=1, devices=gpu_devices)
    yref, yref_e = hover_yref(spec)
    B = 256 * n
    x0s = (hover_state(spec.params, dtype=jnp.float32)[None, :]
           + 0.05 * jax.random.normal(jax.random.PRNGKey(11), (B, NX),
                                      jnp.float32))
    x0s = x0s.at[:, 0].add(0.3)        # saturating transient, every lane
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)

    step = pod_rti_step(spec, mesh, cfg)
    pod_states, pod_outs = step(states, x0s, yref, yref_e)

    ref_states, ref_outs = jax.jit(lambda s, x: rti_step_batched(
        spec, s, x, yref, yref_e, cfg))(states, x0s)
    np.testing.assert_allclose(np.asarray(pod_outs.u0),
                               np.asarray(ref_outs.u0),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pod_states.u_traj),
                               np.asarray(ref_states.u_traj),
                               rtol=1e-3, atol=5e-3)
