"""The alternative solvers of the port (``solvers/centralized.py``,
``pdhg_consensus.py``, ``graph_problem.py``) and the CLI's ``--solver``
against the JAX package on the CPU: each case of the JAX package's
``tests/test_solvers.py``, run by both packages on the same inputs, with
that test's own checks made on the port's result as well.

The problem is a JAX ``save_problem`` bundle (dense, N=16, 3 nodes, 24
angles, const phantom), loaded by the port; the port gets JAX's draws (the
power-method starts of pdhg-consensus, fcv's Lanczos start). Tolerances:
iterates and histories within rtol 1e-4 / atol 1e-4 of their scale where
both run the same float32 iteration (pdhg-consensus, GraphProblem, the
centralized TV solve, whose trip counts must be equal); ridge within 1e-3
of the image's max (the port solves the Gram, of condition ~3e4, in
float64; JAX's float32 Cholesky lands ~1e-4 of the max from it), and
JAX's own dense-vs-CG tolerance between the two forms; the CLI summaries
with the JAX CLI's keys, PSNRs within 1e-3 dB (ridge: 0.05 dB, for the
same Cholesky) and MSEs within rtol 1e-3 (ridge: 1e-2).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.config import (
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.data import loader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.ops import radon
from dip_admm_tpu.runners import cli as jcli
from dip_admm_tpu.solvers import centralized, graph_problem, pdhg_consensus
from dip_admm_tpu.utils.imaging import psnr
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import tv as ttv
from dip_admm_tpu_torch.runners import cli as tcli
from dip_admm_tpu_torch.solvers import centralized as tcentral
from dip_admm_tpu_torch.solvers import graph_problem as tgraph
from dip_admm_tpu_torch.solvers import pdhg_consensus as tpdhg

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-4
RIDGE_TOL = 1e-3


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    cfg = ProblemConfig(
        geometry=GeometryConfig(N=16, num_nodes=3, angles_total=24),
        graph=GraphConfig(strategy="knn", k=1),
        noise_level=0.002,
        phantom="const",
    )
    pj = loader.build_problem(cfg)
    path = str(tmp_path_factory.mktemp("alt") / "problem.npz")
    jser.save_problem(pj, path)
    return pj, tser.load_problem(path, "cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    """got within rtol, and atol times want's max, of want."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1.0))


def _joseph(tp):
    """The port's problem on the Joseph operator (dense's, without A)."""
    tables = tloader.build_tables(tp.cfg, tp.angles, tp.angle_valid,
                                  "joseph")
    return dataclasses.replace(tp, mode="joseph", fft_tables=tables)


def _v0(key, shape):
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(key), shape, jnp.float32)))


def test_ridge_dense_vs_matrix_free(problems):
    pj, tp = problems
    lam = 1e-2
    x_dense = tcentral.ridge_reconstruction(tp, lam=lam)
    x_free = tcentral.ridge_reconstruction(_joseph(tp), lam=lam)
    np.testing.assert_allclose(x_dense.numpy(), x_free.numpy(), atol=2e-2,
                               rtol=1e-2)
    jd = centralized.ridge_reconstruction(pj, lam=lam)
    jf = centralized.ridge_reconstruction(
        dataclasses.replace(pj, mode="joseph", A=None), lam=lam)
    _close(x_dense, jd, rtol=0, atol=RIDGE_TOL)
    _close(x_free, jf, rtol=0, atol=RIDGE_TOL)


def test_centralized_tv_quality(problems):
    pj, tp = problems
    x, g = tcentral.tv_reconstruction(tp, lam_tv=0.02, eps=5e-1)
    x_true = tp.x_true.numpy()
    val = psnr(x.numpy(), x_true, data_range=x_true.max())
    assert val > 20.0, f"centralized PSNR too low: {val}"
    xj, gj = centralized.tv_reconstruction(pj, lam_tv=0.02, eps=5e-1)
    _close(x, xj)
    _close(g, gj, rtol=1e-3)


def _pdhg_pair(pj, tp, cfg_j):
    res_j = pdhg_consensus.solve(pj, cfg_j)
    cfg_t = tpdhg.PdhgConsensusConfig(**dataclasses.asdict(cfg_j))
    res_t = tpdhg.solve(tp, cfg_t, node_v0=_v0(11, (tp.num_nodes, tp.n)),
                        agg_v0=_v0(12, (tp.n,)))
    for name in res_j._fields:
        _close(getattr(res_t, name), getattr(res_j, name))
    return res_t


def test_pdhg_consensus_runs_and_improves(problems):
    pj, tp = problems
    cfg = pdhg_consensus.PdhgConsensusConfig(
        n_outer=100, lam_tv=0.005, lam_agg=0.005, gamma=2.0)
    res = _pdhg_pair(pj, tp, cfg)
    assert res.x_nodes.shape == (3, 256)
    img_mse = res.img_mse_nodes.numpy()
    assert (img_mse[-1] < 0.6 * img_mse[0]).all()
    agg = res.img_mse_agg.numpy()
    assert agg[-1] < 0.85 * agg[0]
    assert np.all(np.diff(agg) <= 1e-3 * agg[0])
    assert np.isfinite(res.x_agg.numpy()).all()


def test_pdhg_residual_anchor_variant(problems):
    pj, tp = problems
    cfg = pdhg_consensus.PdhgConsensusConfig(n_outer=20,
                                             anchor_weights="residual")
    img = _pdhg_pair(pj, tp, cfg).img_mse_nodes.numpy()
    assert np.isfinite(img).all()
    assert (img[-1] < img[0]).all()


def _graph_pair(build, solve_kw, inner=None, lanczos=False):
    """The same graph problem through both packages: (x, history) of the
    port's, held to JAX's."""
    gj = graph_problem.GraphProblem(build["N"])
    gt = tgraph.GraphProblem(build["N"], device="cpu")
    for g in (gj, gt):
        for node in build["nodes"]:
            g.add_node(**node)
        for edge in build["edges"]:
            g.add_edge(*edge)
    kw = dict(solve_kw)
    xj, hj = gj.solve(**kw, inner=inner)
    tinner = (None if inner is None
              else tcfg.NodeSolverConfig(**dataclasses.asdict(inner)))
    v0 = _v0(0, (build["N"] ** 2,)) if lanczos else None
    xt, ht = gt.solve(**kw, inner=tinner, lanczos_v0=v0)
    _close(xt, xj)
    assert set(ht) == set(hj)
    for k in hj:
        np.testing.assert_array_equal(np.isnan(ht[k]), np.isnan(hj[k]))
        _close(np.nan_to_num(ht[k]), np.nan_to_num(hj[k]), rtol=1e-3)
    return xt.numpy(), ht


def test_graph_problem_quadratic_consensus():
    rng = np.random.default_rng(0)
    n = 16
    targets = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    build = dict(N=4, nodes=[dict(A=np.eye(n, dtype=np.float32), b=t)
                             for t in targets],
                 edges=[(0, 1, 1000.0), (1, 2, 1000.0)])
    x, _ = _graph_pair(build, dict(rho=5.0, max_iters=150, eps_pri=1e-9,
                                   eps_dual=1e-9))
    avg = np.mean(targets, axis=0)
    np.testing.assert_allclose(x[0], avg, atol=0.05)
    np.testing.assert_allclose(x[2], avg, atol=0.05)


def test_graph_problem_soft_edges_exact():
    t0, t1, q = 1.0, 3.0, 0.5
    build = dict(N=1, nodes=[
        dict(A=np.ones((1, 1), np.float32), b=np.array([t0], np.float32)),
        dict(A=np.ones((1, 1), np.float32), b=np.array([t1], np.float32))],
        edges=[(0, 1, q)])
    x, _ = _graph_pair(build, dict(rho=1.0, max_iters=300, eps_pri=1e-10,
                                   eps_dual=1e-10))
    M = np.array([[1 + q, -q], [-q, 1 + q]])
    expected = np.linalg.solve(M, np.array([t0, t1]))
    np.testing.assert_allclose(x.ravel(), expected, atol=1e-3)


def _tv_nodes(seed, lams, scale):
    rng = np.random.default_rng(seed)
    n_side, n = 8, 64
    base = np.zeros((n_side, n_side), np.float32)
    base[2:6, 2:6] = 5.0
    target = base.reshape(-1)
    b0 = target + rng.normal(scale=scale, size=n).astype(np.float32)
    nodes = []
    for lam in lams:
        b = b0 if len(set(lams)) > 1 else target + rng.normal(
            scale=scale, size=n).astype(np.float32)
        nodes.append(dict(A=np.eye(n, dtype=np.float32), b=b, lam_tv=lam))
    return target, b0, nodes


def test_graph_problem_with_tv():
    target, _, nodes = _tv_nodes(2, (0.1, 0.1), 0.3)
    x, _ = _graph_pair(dict(N=8, nodes=nodes, edges=[(0, 1, 10.0)]),
                       dict(rho=1.0, max_iters=80))
    assert np.abs(x.mean(axis=0) - target).mean() < 0.25


def test_graph_problem_tv_fcv():
    target, _, nodes = _tv_nodes(2, (0.1, 0.1), 0.3)
    x, _ = _graph_pair(dict(N=8, nodes=nodes, edges=[(0, 1, 10.0)]),
                       dict(rho=1.0, max_iters=80),
                       inner=NodeSolverConfig(max_inner=200, check_every=25,
                                              algorithm="fcv"),
                       lanczos=True)
    assert np.abs(x.mean(axis=0) - target).mean() < 0.25


def test_graph_problem_per_node_lam_tv():
    _, b0, nodes = _tv_nodes(5, (0.0, 0.4), 0.5)
    x, _ = _graph_pair(dict(N=8, nodes=nodes, edges=[(0, 1, 1e-6)]),
                       dict(rho=1.0, max_iters=60))
    x = x.reshape(2, 8, 8)

    def tv(im):
        return (np.abs(np.diff(im, axis=0)).sum()
                + np.abs(np.diff(im, axis=1)).sum())

    assert tv(x[1]) < 0.7 * tv(x[0])
    np.testing.assert_allclose(x[0].reshape(-1), b0, atol=5e-2)


def test_graph_problem_matrix_free_operators():
    """The port's matrix-free GraphProblem on its Joseph node operators
    against its dense stack of the same operator, and both against JAX's
    matrix-free run."""
    geo = GeometryConfig(N=8, num_nodes=2, angles_total=12)
    angles_np, valid_np, _ = radon.node_angles(geo)
    angles = jnp.asarray(angles_np, jnp.float32)
    valid = jnp.asarray(valid_np)
    fwd, adj = loader.make_node_ops("joseph", geo, angles, valid)
    A = np.stack([np.asarray(radon.dense_matrix(geo, angles[i], valid[i]))
                  for i in range(2)])
    rng = np.random.default_rng(0)
    x_true = rng.normal(size=geo.n).astype(np.float32)
    b = np.einsum("pmn,n->pm", A, x_true)
    opn = np.asarray([np.linalg.norm(Ai.T @ Ai, 2) for Ai in A])

    tgeo = tcfg.GeometryConfig(N=8, num_nodes=2, angles_total=12)
    tcfg_p = tcfg.ProblemConfig(geometry=tgeo)
    at = torch.as_tensor(angles_np, dtype=torch.float32)
    vt = torch.as_tensor(valid_np)
    tf, ta = tloader.make_node_ops(
        "joseph", tgeo, tloader.build_tables(tcfg_p, at, vt, "joseph"))
    gj = graph_problem.GraphProblem(geo.N, operators=(fwd, adj, opn))
    gt = tgraph.GraphProblem(geo.N, operators=(tf, ta, opn), device="cpu")
    gd = tgraph.GraphProblem(geo.N, device="cpu")
    for i in range(2):
        gj.add_node(b=b[i])
        gt.add_node(b=b[i])
        gd.add_node(A=A[i], b=b[i])
    for g in (gj, gt, gd):
        g.add_edge(0, 1, 2.0)
    xj, _ = gj.solve(rho=1.0, max_iters=40)
    xt, _ = gt.solve(rho=1.0, max_iters=40)
    xd, _ = gd.solve(rho=1.0, max_iters=40)
    np.testing.assert_allclose(xt.numpy(), xd.numpy(), rtol=1e-4, atol=1e-4)
    _close(xt, xj)


def test_centralized_tv_fcv_matches_cv(problems):
    """fcv reaches cv's centralized TV objective (the rho = 0 path: the
    sigma fallback to the operator's spectral scale), in both packages."""
    pj, tp = problems
    kw = dict(max_inner=6000, check_every=100, plateau_tol=0.0)
    out = {}
    for alg in ("cv", "fcv"):
        x, _ = tcentral.tv_reconstruction(
            tp, lam_tv=0.02, eps=1e-3,
            cfg=tcfg.NodeSolverConfig(**kw, algorithm=alg),
            lanczos_v0=_v0(0, (tp.n,)))
        xj, _ = centralized.tv_reconstruction(
            pj, lam_tv=0.02, eps=1e-3,
            cfg=NodeSolverConfig(**kw, algorithm=alg))
        _close(x, xj, rtol=1e-3, atol=1e-3)
        out[alg] = x
    x_true = tp.x_true.numpy()
    val = psnr(out["fcv"].numpy(), x_true, data_range=x_true.max())
    assert val > 19.0, f"fcv centralized PSNR too low: {val}"
    fwd, _, b = tcentral.aggregate_ops(tp)

    def objective(x):
        r = fwd(x[None]) - b
        return 0.5 * float((r * r).sum()) + 0.02 * float(
            ttv.tv_value(x.reshape(16, 16)))

    o_cv, o_f = objective(out["cv"]), objective(out["fcv"])
    assert abs(o_f - o_cv) <= 5e-2 * max(abs(o_cv), 1.0), (o_f, o_cv)


# The CLI: each solver's summary through both packages' ``main``.
CLI_ARGS = ("--N", "16", "--nodes", "3", "--pdhg-outer", "10")
CLI_TOL = {  # (PSNR dB, MSE rtol)
    "pdhg-consensus": (1e-3, 1e-3),
    "centralized": (0.05, 1e-2),
    "centralized-tv": (1e-3, 1e-3),
}


@pytest.mark.parametrize("solver", list(CLI_TOL))
def test_cli_solver_summary_matches_jax(solver, tmp_path, capsys):
    jcli.main([*CLI_ARGS, "--solver", solver, "--out",
               str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out)[solver]
    got = tcli.main(["--device", "cpu", *CLI_ARGS, "--solver", solver,
                     "--out", str(tmp_path / "port")])[solver]
    got.pop("artifacts_skipped", None)
    assert set(got) == set(want)
    assert got["solver"] == want["solver"]
    assert got["out_dir"].endswith(want["out_dir"].rsplit("/", 1)[-1])
    db, rel = CLI_TOL[solver]
    for k, v in want.items():
        if k in ("solver", "out_dir"):
            continue
        if "psnr" in k:
            assert abs(got[k] - v) <= db, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=rel, err_msg=k)


@pytest.mark.parametrize("extra", [("--mesh", "2"), ("--all-strategies",),
                                   ("--checkpoint-every", "2")],
                         ids=["mesh", "all_strategies", "checkpoint"])
def test_cli_solver_refuses_admm_only_flags(extra, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--device", "cpu", "--solver", "centralized", *extra])
    assert e.value.code != 0
    assert "admm" in capsys.readouterr().err
