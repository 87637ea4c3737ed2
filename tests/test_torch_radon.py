"""The port's Joseph projector and dense operator (``ops/radon.py``) and
its ``dense`` and ``joseph`` problems, against the JAX package on the CPU.

Seeded numpy inputs go through both packages at N <= 32, parallel and fan
beam, with ragged angle counts (each node's angle set padded to m_max).
Tolerances: the operators, column norms and dense matrices within 1e-5 of
the output's max (float32 ray geometry computed in another order moves a
crossing by an ulp; the weights are continuous in it); the adjoint identity
within 1e-5 relative; the adjoint and column norms equal bit for bit across
two calls. Builds given JAX's noise draw and power-method start: b within
1e-5 of its max, W and Q within 1e-5, the graph equal, opnorm within 1e-4.
Three outers from a JAX bundle: X, Z, Y within rtol 1e-4 / atol 1e-5 of
the image scale, the histories within rtol 1e-3 / atol 1e-5, the
acceptance counts equal.
"""

import dataclasses

import _torch_mesh_worker as worker
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.ops import radon as jradon
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

OP_TOL = 1e-5
ADJ_TOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
HIST_RTOL = 1e-3

# N=24 with 50 angles over 3 nodes: m = 17, 17, 16 (the last padded).
GEOS = {
    "parallel": dict(N=24, num_nodes=3, angles_total=50),
    "fan": dict(N=24, num_nodes=3, angles_total=50, fan_beam=True,
                det_width_factor=2.0),
}


def _geos(kind):
    return (jcfg.GeometryConfig(**GEOS[kind]),
            tcfg.GeometryConfig(**GEOS[kind]))


@pytest.fixture(scope="module", params=list(GEOS))
def ops(request):
    """Both packages' per-node operators of one geometry, and seeded
    inputs (the sinograms zero on padded angles)."""
    gj, gt = _geos(request.param)
    a, v, _ = jradon.node_angles(gj)
    aj, vj = jnp.asarray(a, jnp.float32), jnp.asarray(v)
    at, vt = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v)
    P, N, D = gj.num_nodes, gj.N, gj.n_det
    rng = np.random.default_rng(0)
    x = rng.standard_normal((P, N, N)).astype(np.float32)
    y = (rng.standard_normal((P, a.shape[1], D))
         * v[:, :, None]).astype(np.float32)
    tables = tradon.joseph_tables(gt, at, vt)
    return dict(gj=gj, gt=gt, aj=aj, vj=vj, at=at, vt=vt, x=x, y=y,
                tables=tables)


def _close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_joseph_project_matches_jax(ops):
    want = jradon.project_nodes(ops["gj"], jnp.asarray(ops["x"]), ops["aj"],
                                ops["vj"])
    got = tradon.project_nodes(ops["gt"], torch.as_tensor(ops["x"]),
                               ops["tables"])
    _close(got.numpy(), want)
    # the single-node form, which integrates ray by ray
    one = tradon.project(ops["gt"], torch.as_tensor(ops["x"][2]),
                         ops["at"][2], ops["vt"][2])
    _close(one.numpy(), np.asarray(want)[2])
    # the squared weights, ray by ray (padded angles masked)
    img = ops["x"][2]
    vj = ops["vj"][2][:, None]
    sq_j = jradon.joseph_project(jnp.asarray(img), *jradon.make_rays(
        ops["gj"], ops["aj"][2]), valid=vj, squared=True)
    sq_t = tradon.joseph_project(torch.as_tensor(img), *tradon.make_rays(
        ops["gt"], ops["at"][2]), valid=ops["vt"][2][:, None], squared=True)
    _close(sq_t.numpy(), sq_j)


def test_joseph_backproject_matches_jax(ops):
    want = jradon.backproject_nodes(ops["gj"], jnp.asarray(ops["y"]),
                                    ops["aj"], ops["vj"])
    got = tradon.backproject_nodes(ops["gt"], torch.as_tensor(ops["y"]),
                                   ops["tables"])
    _close(got.numpy(), want)
    one = tradon.backproject(ops["gt"], torch.as_tensor(ops["y"][2]),
                             ops["at"][2], ops["vt"][2])
    _close(one.numpy(), np.asarray(want)[2])


def test_colnorms_sq_matches_jax(ops):
    for i in range(ops["gj"].num_nodes):
        want = jradon.colnorms_sq(ops["gj"], ops["aj"][i], ops["vj"][i])
        got = tradon.colnorms_sq(ops["gt"], ops["at"][i], ops["vt"][i])
        _close(got.numpy(), want)
    W = tradon.colnorms_sq_nodes(ops["tables"]).numpy()
    _close(W[0], np.asarray(jradon.colnorms_sq(ops["gj"], ops["aj"][0],
                                               ops["vj"][0])).reshape(-1))


def test_dense_matrix_matches_jax_and_joseph(ops):
    gt, x = ops["gt"], ops["x"]
    fwd = tradon.project_nodes(gt, torch.as_tensor(x), ops["tables"]).numpy()
    for i in (0, 2):  # a full node and a padded one
        want = jradon.dense_matrix(ops["gj"], ops["aj"][i], ops["vj"][i])
        got = tradon.dense_matrix(gt, ops["at"][i], ops["vt"][i], chunk=8)
        assert got.shape == want.shape
        _close(got.numpy(), want)
        _close(got.numpy() @ x[i].reshape(-1), fwd[i].reshape(-1))


@pytest.mark.parametrize("mode", ["dense", "joseph"])
def test_adjoint_identity(ops, mode):
    gt = ops["gt"]
    t = (ops["tables"] if mode == "joseph"
         else tloader.build_tables(tcfg.ProblemConfig(geometry=gt),
                                   ops["at"], ops["vt"], "dense"))
    fwd, adj = tloader.make_node_ops(mode, gt, t)
    x = torch.as_tensor(ops["x"]).reshape(gt.num_nodes, -1).double()
    y = torch.as_tensor(ops["y"]).reshape(gt.num_nodes, -1).double()
    lhs = float(torch.sum(fwd(x.float()).double() * y))
    rhs = float(torch.sum(x * adj(y.float()).double()))
    assert abs(lhs - rhs) <= ADJ_TOL * abs(lhs)


def test_joseph_adjoint_and_colnorms_repeat_bitwise(ops):
    gt = ops["gt"]
    y = torch.as_tensor(ops["y"])
    a = tradon.backproject_nodes(gt, y, ops["tables"])
    t2 = tradon.joseph_tables(gt, ops["at"], ops["vt"])
    b = tradon.backproject_nodes(gt, y, t2)
    assert torch.equal(a, b)
    assert torch.equal(tradon.colnorms_sq_nodes(ops["tables"]),
                       tradon.colnorms_sq_nodes(t2))


def test_transpose_taps_layout():
    """Each pixel's taps in ray order; empty slots read ray R (zero)."""
    idx = torch.tensor([[0, 2], [2, 1], [0, 0]])
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 0.0]])
    src, tw = tradon.transpose_taps(idx, w, 4)
    assert src.tolist() == [[0, 2], [1, 3], [0, 1], [3, 3]]
    assert tw.tolist() == [[1.0, 5.0], [4.0, 0.0], [2.0, 3.0], [0.0, 0.0]]


# ---------------------------------------------------------------------------
# The auto rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fan", [False, True], ids=["parallel", "fan"])
@pytest.mark.parametrize("N, mode, dense, want", [
    (64, None, None, "dense"),
    (128, None, None, "dense"),
    (129, None, None, "fft_skew"),
    (512, None, None, "fft_skew"),
    (256, None, True, "dense"),
    (64, None, False, "joseph"),
    (64, "fft_grouped", True, "fft_grouped"),
])
def test_resolve_mode_is_the_jax_rule(fan, N, mode, dense, want):
    geo = tcfg.GeometryConfig(N=N, num_nodes=2, fan_beam=fan)
    assert tloader.resolve_mode(geo, mode, dense) == want


def test_build_problem_mode_none_is_dense_and_dense_false_joseph():
    cfg = tcfg.ProblemConfig(geometry=tcfg.GeometryConfig(
        N=16, num_nodes=2, angles_total=20))
    p = tloader.build_problem(cfg, "cpu")
    assert p.mode == "dense" and p.A.shape == (2, 10 * 16, 256)
    q = tloader.build_problem(cfg, "cpu", dense=False)
    assert q.mode == "joseph" and q.A is None
    _close(q.b.numpy(), p.b.numpy())


# ---------------------------------------------------------------------------
# Problems built by the port and loaded from JAX bundles
# ---------------------------------------------------------------------------


def _cfg_jax(kind, **admm):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(**GEOS[kind]),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=3, eps_pri=0.0, eps_dual=0.0, use_pallas=False,
            node=jcfg.NodeSolverConfig(max_inner=20, check_every=5), **admm),
        phantom="shepp",
    )


def port_cfg(cfg_j):
    """The same configuration as the port's dataclasses."""
    d = dataclasses.asdict(cfg_j)
    return tcfg.ProblemConfig(
        geometry=tcfg.GeometryConfig(**d["geometry"]),
        graph=tcfg.GraphConfig(**d["graph"]),
        admm=tcfg.AdmmConfig(**{**d["admm"], "node": tcfg.NodeSolverConfig(
            **d["admm"]["node"])}),
        **{k: v for k, v in d.items() if k not in ("geometry", "graph", "admm")},
    )


@pytest.mark.parametrize("kind", list(GEOS))
@pytest.mark.parametrize("mode", ["dense", "joseph"])
def test_port_build_matches_jax(kind, mode):
    cfg_j = _cfg_jax(kind)
    pj = jloader.build_problem(cfg_j, mode=mode)
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(port_cfg(cfg_j), "cpu", mode=mode,
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    assert pt.mode == pj.mode == mode
    _close(pt.b.numpy(), pj.b)
    for k in ("W", "Q"):
        want = np.asarray(getattr(pj, k))
        np.testing.assert_allclose(getattr(pt, k).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * want.max())
    np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep))
    np.testing.assert_array_equal(pt.adj.numpy(), np.asarray(pj.adj))
    np.testing.assert_allclose(pt.opnorm.numpy(), np.asarray(pj.opnorm),
                               rtol=1e-4)
    if mode == "dense":
        _close(pt.A.numpy(), pj.A)


@pytest.fixture(scope="module", params=["dense", "joseph"])
def bundle(request, tmp_path_factory):
    cfg = _cfg_jax("parallel")
    pj = jloader.build_problem(cfg, mode=request.param)
    path = str(tmp_path_factory.mktemp("bundle") / "problem.npz")
    jser.save_problem(pj, path)
    return cfg, pj, path


def assert_runs_close(res_t, res_j):
    scale = float(np.abs(np.asarray(res_j.x)).max())
    for got, want in ((res_t.x, res_j.x), (res_t.state.Z, res_j.state.Z),
                      (res_t.state.Y, res_j.state.Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STATE_RTOL, atol=STATE_ATOL * scale)
    assert res_t.n_iters == int(res_j.n_iters)
    for name in ("inner_iters", "accept_code"):
        np.testing.assert_array_equal(res_t.history[name].numpy(),
                                      np.asarray(res_j.history[name]))
    for name, v in res_j.history.items():
        np.testing.assert_allclose(res_t.history[name].numpy(), np.asarray(v),
                                   rtol=HIST_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


def test_loaded_bundle_three_outers_match_jax(bundle):
    cfg, pj, path = bundle
    tp = tser.load_problem(path, "cpu")
    assert tp.mode == pj.mode
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(cfg)
    for k in ("b", "W", "Q", "opnorm"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(pj, k)))
    assert_runs_close(tadmm.run_admm(tp, tp.cfg.admm),
                      jadmm.run_admm(pj, cfg.admm))


def test_fan_dense_bundle_loads(tmp_path):
    cfg = _cfg_jax("fan")
    pj = jloader.build_problem(cfg, mode="dense")
    jser.save_problem(pj, str(tmp_path / "p.npz"))
    tp = tser.load_problem(str(tmp_path / "p.npz"), "cpu")
    assert tp.mode == "dense"
    np.testing.assert_array_equal(tp.A.numpy(), np.asarray(pj.A))
    x = np.random.default_rng(1).standard_normal(
        (3, cfg.geometry.n)).astype(np.float32)
    _close(tp.forward(torch.as_tensor(x)).numpy(),
           pj.forward(jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["dense", "joseph"])
def test_mesh_2x2_matches_single_device(mode, tmp_path):
    """Dense and Joseph on a 2 x 2 node x pixel gloo mesh (node slices of
    A or of the tap tables, full images on each pixel rank) against the
    port's one-process run of the same JAX bundle: x within rtol 2e-4 /
    atol 2e-4, the histories within rtol 2e-3 / atol 1e-5 (the mesh
    tests' tolerances, ``test_torch_sharded.py``)."""
    cfg = dataclasses.replace(_cfg_jax("parallel"), geometry=jcfg.GeometryConfig(
        N=16, num_nodes=4, angles_total=24))
    path = str(tmp_path / "problem.npz")
    jser.save_problem(jloader.build_problem(cfg, mode=mode), path)
    p = tser.load_problem(path, "cpu")
    ref = tadmm.run_admm(p, p.cfg.admm)
    got = tmesh.launch(worker.admm_run, 4, "cpu",
                       args=({"bundle": path}, 2, 2, {}, None),
                       init_file=str(tmp_path / "rendezvous"))[0]
    assert not got["pixel_compute"]
    full = got["full"]
    assert full["n_iters"] == ref.n_iters == 3
    np.testing.assert_allclose(full["x"], ref.x.numpy(), rtol=2e-4,
                               atol=2e-4)
    for name, v in ref.history.items():
        np.testing.assert_allclose(full["history"][name], v.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=name)
