"""The port's inner solvers pcv, ppdhg and fista, its Chambolle TV prox and
adapt_rho (both modes), against the JAX package on the CPU.

Both packages run one JAX ``save_problem`` bundle (dense, N=24, 4 nodes)
with the torch-op / XLA consensus. Tolerances: the TV prox within 1e-5 of
the image's max; a node solve's x within rtol 1e-4 / atol 1e-5 of the
image scale, its residuals and objectives within rtol 1e-3 and its
acceptance counts equal; outer runs as in ``test_torch_radon.py`` (X, Z, Y
within rtol 1e-4 / atol 1e-5 of the image scale, histories within rtol
1e-3 / atol 1e-5, acceptance counts equal), and under adapt_rho the rho
trajectory equal to JAX's. The mesh runs: x within rtol 2e-4 / atol 2e-4
and histories within rtol 2e-3 / atol 1e-5 of a one-process run (the
mesh tests' tolerances), the rho trajectory equal.
"""

import dataclasses

import _torch_mesh_worker as worker
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_radon import assert_runs_close

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.core import node_solver as jns
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.ops import tv as jtv
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.core import node_solver as tns
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import tv as ttv
from dip_admm_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

RTOL, ATOL, G_RTOL = 1e-4, 1e-5, 1e-3


def _cfg(**admm):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(N=24, num_nodes=4, angles_total=40),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=3, eps_pri=0.0, eps_dual=0.0, use_pallas=False,
            node=jcfg.NodeSolverConfig(max_inner=20, check_every=5), **admm),
        phantom="shepp",
    )


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = _cfg()
    pj = jloader.build_problem(cfg, mode="dense")
    path = str(tmp_path_factory.mktemp("bundle") / "problem.npz")
    jser.save_problem(pj, path)
    return cfg, pj, path, tser.load_problem(path, "cpu")


@pytest.mark.parametrize("case", ["scalar", "per_node_warm"])
def test_tv_prox_chambolle_matches_jax(case):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 20, 20)).astype(np.float32)
    if case == "scalar":
        weight, p_init, iters = 0.3, None, 20
    else:
        weight = np.array([0.1, 0.5, 2.0], np.float32)[:, None, None]
        p_init = tuple(0.05 * rng.standard_normal((2, 3, 20, 20)).astype(
            np.float32))
        iters = 8
    xj, (pxj, pyj) = jtv.tv_prox_chambolle(
        jnp.asarray(w), jnp.asarray(weight), n_iters=iters,
        p_init=None if p_init is None else tuple(map(jnp.asarray, p_init)))
    xt, (pxt, pyt) = ttv.tv_prox_chambolle(
        torch.as_tensor(w), torch.as_tensor(weight) if case != "scalar"
        else weight, n_iters=iters,
        p_init=None if p_init is None else tuple(map(torch.as_tensor,
                                                     p_init)))
    for got, want in ((xt, xj), (pxt, pxj), (pyt, pyj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("algorithm", ["pcv", "ppdhg", "fista"])
def test_solve_nodes_matches_jax(bundle, algorithm):
    """One batched node solve from the same inputs: a random consensus
    quadratic and a warm start away from zero."""
    cfg, pj, _, tp = bundle
    P, n, N = 4, pj.n, pj.N
    rng = np.random.default_rng(5)
    scale = float(np.abs(np.asarray(pj.x_true)).max())
    V = (scale * rng.random((P, P, n))).astype(np.float32)
    x0 = (scale * rng.random((P, n))).astype(np.float32)
    Q = np.asarray(pj.Q)
    D = Q.sum(1)
    bc = (Q * V).sum(1)
    cq = (Q * V * V).sum((1, 2))
    rho, lam = 2.0, 0.02
    L = np.asarray(pj.opnorm) + rho * D.max(-1)
    node = jcfg.NodeSolverConfig(max_inner=30, check_every=5,
                                 algorithm=algorithm, fista_prox_iters=4)
    sj = jns.init_state(P, N, pj.m_flat)._replace(x=jnp.asarray(x0))
    rj = jns.solve_nodes(pj.forward, pj.adjoint, pj.b, jnp.asarray(D),
                         jnp.asarray(bc), jnp.asarray(cq), lam, rho,
                         jnp.asarray(L), sj, jnp.float32(0.5), node, N)
    st = tns.init_state(P, N, tp.m_flat, "cpu")._replace(
        x=torch.as_tensor(x0))
    rt = tns.solve_nodes(tp.forward, tp.adjoint, tp.b, torch.as_tensor(D),
                         torch.as_tensor(bc), torch.as_tensor(cq), lam, rho,
                         torch.as_tensor(L), st, torch.tensor(0.5),
                         _port_node(node), N)
    for name in ("x", "ux", "uy", "ua", "xp", "tk"):
        want = np.asarray(getattr(rj.state, name))
        np.testing.assert_allclose(
            getattr(rt.state, name).numpy(), want, rtol=RTOL,
            atol=ATOL * max(np.abs(want).max(), 1.0), err_msg=name)
    assert rt.trip_count == int(rj.trip_count)
    np.testing.assert_array_equal(rt.inner_iters.numpy(),
                                  np.asarray(rj.inner_iters))
    np.testing.assert_array_equal(rt.accept_code.numpy(),
                                  np.asarray(rj.accept_code))
    for got, want in ((rt.g_norm, rj.g_norm), (rt.objective, rj.objective)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=G_RTOL)


def _port_node(node):
    return tcfg.NodeSolverConfig(**dataclasses.asdict(node))


@pytest.mark.parametrize("algorithm", ["pcv", "ppdhg", "fista"])
def test_three_outers_match_jax(bundle, algorithm):
    cfg, pj, _, tp = bundle
    changes = {"node": {"algorithm": algorithm}}
    assert_runs_close(
        tadmm.run_admm(tp, worker.over(tp.cfg.admm, changes)),
        jadmm.run_admm(pj, worker.over(cfg.admm, changes)))


# adapt_rho: set so that rho changes at least twice in 10 outers.
RHO_CASES = {
    "balance": {"adapt_rho": True, "rho_mu": 1.5, "max_iters": 10},
    "stall": {"adapt_rho": True, "adapt_rho_mode": "stall",
              "rho_stall_window": 2, "rho_stall_tol": 0.9, "max_iters": 10},
}


@pytest.fixture(scope="module")
def jax_rho_runs(bundle):
    cfg, pj, _, _ = bundle
    return {case: jadmm.run_admm(pj, worker.over(cfg.admm, ch))
            for case, ch in RHO_CASES.items()}


@pytest.mark.parametrize("case", list(RHO_CASES))
def test_adapt_rho_matches_jax(bundle, jax_rho_runs, case):
    _, _, _, tp = bundle
    res_j = jax_rho_runs[case]
    res_t = tadmm.run_admm(tp, worker.over(tp.cfg.admm, RHO_CASES[case]))
    rho_j = np.asarray(res_j.history["rho"])
    assert len(set(rho_j.tolist())) >= 3  # two changes at least
    np.testing.assert_array_equal(res_t.history["rho"].numpy(), rho_j)
    assert float(res_t.state.rho_scale) == float(res_j.state.rho_scale)
    assert_runs_close(res_t, res_j)


def test_adapt_rho_fcv_matches_jax(bundle):
    """fcv under balance: the step scaled by min(1, rho0/rho_k) and the
    tk reset, with JAX's Lanczos start."""
    cfg, pj, _, tp = bundle
    changes = {**RHO_CASES["balance"], "max_iters": 6,
               "node": {"algorithm": "fcv", "max_inner": 15,
                        "check_every": 15}}
    res_j = jadmm.run_admm(pj, worker.over(cfg.admm, changes))
    v0 = torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (pj.n,), jnp.float32)))
    res_t = tadmm.run_admm(tp, worker.over(tp.cfg.admm, changes),
                           lanczos_v0=v0)
    np.testing.assert_array_equal(res_t.history["rho"].numpy(),
                                  np.asarray(res_j.history["rho"]))
    assert_runs_close(res_t, res_j)


@pytest.mark.parametrize("case", list(RHO_CASES))
def test_adapt_rho_resume_equals_straight_run(bundle, case):
    """The resume contract under adapt_rho: 4 outers, then the rest,
    equal one straight run bit for bit (rho_scale and the history carry
    everything the policy reads)."""
    _, _, _, tp = bundle
    cfg = worker.over(tp.cfg.admm, RHO_CASES[case])
    full = tadmm.run_admm(tp, cfg)
    part = tadmm.run_admm(tp, cfg, until=4)
    rest = tadmm.run_admm(tp, cfg, state=part.state, hist=part.history)
    assert rest.n_iters == full.n_iters == 10
    for got, want in ((rest.x, full.x), (rest.state.Z, full.state.Z),
                      (rest.state.Y, full.state.Y),
                      (rest.state.rho_scale, full.state.rho_scale)):
        assert torch.equal(got, want)
    for name, v in full.history.items():
        assert torch.equal(rest.history[name].nan_to_num(-1),
                           v.nan_to_num(-1)), name


@pytest.mark.parametrize("changes", [
    RHO_CASES["balance"],
    {"node": {"algorithm": "ppdhg"}},
], ids=["adapt_rho", "ppdhg"])
def test_mesh_2x2_matches_single_device(bundle, tmp_path, changes):
    """adapt_rho and an inner solver on a 2 x 2 gloo mesh (dense, node
    slices of A): every rank takes the same rho factor."""
    _, _, path, tp = bundle
    ref = tadmm.run_admm(tp, worker.over(tp.cfg.admm, changes))
    got = tmesh.launch(worker.admm_run, 4, "cpu",
                       args=({"bundle": path}, 2, 2, changes, None),
                       init_file=str(tmp_path / "rendezvous"))[0]["full"]
    assert got["n_iters"] == ref.n_iters
    np.testing.assert_allclose(got["x"], ref.x.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(got["history"]["rho"],
                                  ref.history["rho"].numpy())
    for name, v in ref.history.items():
        np.testing.assert_allclose(got["history"][name], v.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=name)
