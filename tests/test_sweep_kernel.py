"""The GPU sweep kernel against the plain batch-last sweeps, and what
surrounds it: the backend choice, lane padding, the long horizon and the
compile-cache path.

Here the kernel runs in the Pallas interpreter (sweep="interpret"); the
`gpu`-marked test runs its compiled form on a GPU host.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crazyflie_nmpc_tpu.ops import backend, ipm, ipm_fast, sweeps
from crazyflie_nmpc_tpu.ops.pallas import sweep_kernel as sk
from crazyflie_nmpc_tpu.ops.qp import QPData
from crazyflie_nmpc_tpu.utils import cache


def random_condensed(key, M, B, dtype=jnp.float32):
    """Random condensed-stage data (dense Q, cross term, input block) in
    the batch-last layout of `ops.sweeps.kkt_sweep`."""
    k = jax.random.split(key, 12)
    nrm = lambda i, s: jax.random.normal(k[i], s, dtype)
    eye = jnp.eye(13, dtype=dtype)[None, :, :, None]
    G = nrm(3, (M, 13, 13, B))
    H = nrm(5, (M, 4, 4, B))
    return dict(
        A=eye + 0.1 * nrm(0, (M, 13, 13, B)), Bm=nrm(1, (M, 13, 8, B)),
        c=0.1 * nrm(2, (M, 13, B)), Q=0.1 * sweeps.mtm(G, G) + eye,
        S1T=0.1 * nrm(4, (M, 4, 13, B)), R00=0.1 * sweeps.mtm(H, H),
        qx=nrm(6, (M, 13, B)),
        ruu=0.5 + jax.random.uniform(k[7], (M, 8, B), dtype),
        ru=nrm(8, (M, 8, B)),
        pT=1.0 + jax.random.uniform(k[9], (13, B), dtype),
        pt=nrm(10, (13, B)), dx0=nrm(11, (13, B)))


def plain_and_kernel(d):
    S, R = sweeps.split_condensed_cost(d["S1T"], d["R00"])
    ref = sweeps.kkt_sweep(d["A"], d["Bm"], d["c"], d["Q"], S, R, d["qx"],
                           d["ruu"], d["ru"], d["pT"], d["pt"], d["dx0"])
    data = sk.stage_data(d["A"], d["Bm"], d["Q"], d["S1T"], d["R00"])
    out = sk.kkt_sweep_c2(data, d["c"], d["qx"], d["ruu"], d["ru"],
                          d["pT"], d["pt"], d["dx0"], interpret=True)
    return ref, out, data


@pytest.mark.parametrize("M", [5, 25])              # N = 10 and N = 50
def test_sweep_kernel_sweeps_match_plain(M):
    """Both sweeps, kernel (interpreted) against plain: gains, rollout,
    and the corrector on a second right-hand side."""
    B = 20
    d = random_condensed(jax.random.PRNGKey(M), M, B)
    ref, out, data = plain_and_kernel(d)
    K, kff, L, Pc, dx, du = out
    B_ = slice(0, B)
    for name, got, want in (("K", K[:, :, :13, B_], ref[0]),
                            ("kff", kff[..., B_], ref[1]),
                            ("L", L[..., B_], ref[2]),
                            ("Pc", Pc[:, :13, B_], ref[3]),
                            ("dx", dx, ref[4]), ("du", du, ref[5])):
        scale = float(jnp.max(jnp.abs(want)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)
    # padded rows and columns of the gains stay exactly zero
    assert float(jnp.max(jnp.abs(K[:, :, 13:]))) == 0.0
    assert float(jnp.max(jnp.abs(Pc[:, 13:]))) == 0.0

    dx2, du2 = sk.corrector_sweep_c2(data, d["c"], 2 * d["qx"], -d["ru"],
                                     K, L, Pc, 0.3 * d["pt"], d["dx0"],
                                     interpret=True)
    rdx, rdu = sweeps.corrector_sweep(d["A"], d["Bm"], d["c"], 2 * d["qx"],
                                      -d["ru"], ref[0], ref[2], ref[3],
                                      0.3 * d["pt"], d["dx0"])
    for got, want in ((dx2, rdx), (du2, rdu)):
        scale = float(jnp.max(jnp.abs(want)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=2e-5 * max(scale, 1.0))


def _random_qps(key, N, B, bounded):
    """B random diagonal-cost LQs (the batched solver's contract)."""
    qps = []
    for kk in jax.random.split(key, B):
        ks = jax.random.split(kk, 10)
        f = jnp.float32
        A = (0.25 * jax.random.normal(ks[0], (N, 13, 13), f)
             + 0.5 * jnp.eye(13, dtype=f))
        lim = 0.5 if bounded else jnp.inf
        qps.append(QPData(
            A=A, B=jax.random.normal(ks[1], (N, 13, 4), f),
            c=0.1 * jax.random.normal(ks[2], (N, 13), f),
            Qxx=jax.vmap(jnp.diag)(0.2 + jax.random.uniform(ks[3], (N, 13),
                                                            f)),
            qx=jax.random.normal(ks[4], (N, 13), f),
            Ruu=jax.vmap(jnp.diag)(0.2 + jax.random.uniform(ks[5], (N, 4),
                                                            f)),
            ru=jax.random.normal(ks[6], (N, 4), f),
            S=jnp.zeros((N, 4, 13), f),
            P=jnp.diag(0.2 + jax.random.uniform(ks[7], (13,), f)),
            p=jax.random.normal(ks[8], (13,), f),
            lb=jnp.full((N, 4), -lim, f), ub=jnp.full((N, 4), lim, f),
            dx0=jax.random.normal(ks[9], (13,), f)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qps)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("N", [10, 50])
def test_sweep_kernel_ipm_matches_plain(N, bounded):
    """The condensed batched IPM with the kernel's sweeps (interpreted)
    solves the same QPs as with the plain sweeps."""
    qp = ipm_fast.from_qpdata(_random_qps(jax.random.PRNGKey(N), N, 6,
                                          bounded))
    cfg = ipm.IPMConfig(iters=8)
    sols = {sw: ipm_fast.solve_batched(qp, cfg, condense=2, sweep=sw)
            for sw in ("plain", "interpret")}
    for field in ("du", "dx", "lam_l"):
        a = getattr(sols["interpret"], field)
        b = getattr(sols["plain"], field)
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-4, err_msg=field)


@pytest.mark.parametrize("B", [1, 5, 130])
def test_sweep_kernel_lane_padding(B):
    """B not a multiple of the lane block: the wrappers pad (repeating the
    last lane) and slice, and every real lane equals the unpadded plain
    result."""
    d = random_condensed(jax.random.PRNGKey(B), 3, B)
    ref, out, data = plain_and_kernel(d)
    assert data[0].shape[-1] % sk.LANES == 0
    assert out[4].shape == ref[4].shape and out[5].shape == ref[5].shape
    np.testing.assert_allclose(np.asarray(out[5]), np.asarray(ref[5]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out[4]), np.asarray(ref[4]),
                               rtol=0, atol=1e-4)
    padded = sk.pad_lanes(d["dx0"])
    assert padded.shape[-1] == -(-B // sk.LANES) * sk.LANES
    tail = np.asarray(padded[:, B:])
    np.testing.assert_array_equal(
        tail, np.broadcast_to(np.asarray(padded[:, B - 1:B]), tail.shape))


@pytest.mark.parametrize("sweep", ["plain", "interpret"])
def test_long_horizon_batched_matches_ipm(sweep):
    """N=400 through the batched step (block-2 condensing, gains in
    device memory at any horizon) == the single-problem RTI step on
    `ops.ipm`, both at f64."""
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.solver import (
        default_ocp,
        hover_yref,
        init_rti,
        rti_step,
    )
    from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched

    spec = default_ocp(N=400, tf=6.0, dtype=jnp.float64)
    yref, yref_e = hover_yref(spec)
    x0s = jnp.stack([hover_state(spec.params, pos=(0.2, -0.1, 0.4)),
                     hover_state(spec.params, pos=(-0.1, 0.05, 0.55))])
    states = jax.vmap(lambda x: init_rti(spec, x))(x0s)
    cfg = ipm.IPMConfig(iters=8)
    _, out = jax.jit(lambda s, x: rti_step_batched(
        spec, s, x, yref, yref_e, cfg, sweep=sweep))(states, x0s)
    _, ref = jax.jit(jax.vmap(lambda s, x: rti_step(
        spec, s, x, yref, yref_e, cfg)))(states, x0s)
    assert out.u_plan.shape == (2, 400, 4)
    np.testing.assert_allclose(np.asarray(out.u_plan),
                               np.asarray(ref.u_plan), rtol=0, atol=1e-7)


@pytest.mark.parametrize("platform,choice",
                         [("gpu", "kernel"), ("cpu", "plain")])
def test_sweep_backend(platform, choice):
    assert backend.sweep_backend(platform) == choice


@pytest.mark.parametrize("sweep,want", [(None, "plain"), ("plain", "plain"),
                                        ("kernel", "kernel"),
                                        ("interpret", "interpret")])
def test_resolve_sweep(sweep, want):
    """None defers to the platform (the CPU here); interpret mode only on
    request."""
    assert backend.resolve_sweep(sweep) == want


def test_resolve_sweep_rejects_unknown():
    with pytest.raises(ValueError):
        backend.resolve_sweep("pallas")


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_dir(env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed,
    gitignored directory inside the checkout."""
    environ = {} if env is None else {cache.ENV_VAR: env}
    got = cache.cache_dir(environ)
    if env is not None:
        assert got == env
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
def test_sweep_kernel_compiled_matches_plain(gpu_devices):
    """The compiled kernel on the card at the production width (N=50,
    B=4096) against the plain sweeps on the same f32 inputs."""
    d = random_condensed(jax.random.PRNGKey(0), 25, 4096)
    d = jax.device_put(d, gpu_devices[0])
    S, R = sweeps.split_condensed_cost(d["S1T"], d["R00"])
    ref = jax.jit(sweeps.kkt_sweep)(d["A"], d["Bm"], d["c"], d["Q"], S, R,
                                    d["qx"], d["ruu"], d["ru"], d["pT"],
                                    d["pt"], d["dx0"])
    data = sk.stage_data(d["A"], d["Bm"], d["Q"], d["S1T"], d["R00"])
    out = jax.jit(sk.kkt_sweep_c2)(data, d["c"], d["qx"], d["ruu"],
                                   d["ru"], d["pT"], d["pt"], d["dx0"])
    assert bool(jnp.all(jnp.isfinite(out[5])))
    np.testing.assert_allclose(np.asarray(out[5]), np.asarray(ref[5]),
                               rtol=0, atol=2e-3)
