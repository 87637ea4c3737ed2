"""Mode ``fft`` (the matrix-free split-table projector) in the PyTorch port
against the JAX package, on the CPU, in parallel and fan beam, at small
sizes (N = 16-24, 2-3 nodes), on numpy-seeded inputs.

Tolerances: f32 tables to 1e-5 of their max (the phases are correctly
rounded in the port, evaluated by XLA's complex64 exp, up to 4e-6 apart
here), bf16 tables to one bf16 ulp beyond that (an entry near a rounding
boundary rounds either way); the operators to 1e-5 of the output's max
with f32 tables and 2e-3 with bf16 tables; the adjoint identity to 1e-5
relative; the build (b, W, Q 1e-5, opnorm 1e-4) and three outers (states
1e-4, histories 1e-3) as in ``test_torch_admm.py``. Mode ``fft`` runs
no kernel: torch FFTs and products where the JAX package runs XLA's."""

import dataclasses

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
from dip_admm_tpu.ops import radon_fan as jfan
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import radon_fan as tfan
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import consensus, filter_sum, shear_sum
from dip_admm_tpu_torch.parallel import mesh as tmesh

from test_torch_fan import _flat, _port_cfg

torch.set_num_threads(2)

TABLE_RTOL = 1e-5
OP_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
ADJ_RTOL = 1e-5
RTOL, ATOL, HIST_RTOL = 1e-4, 1e-5, 1e-3

# Parallel: 31 angles over 3 nodes, so node 2 has a padded (invalid) row;
# "wide": the wide-detector window of the JAX package's test_radon_fft.py.
PARALLEL = {
    "N24P3": dict(N=24, num_nodes=3, angles_total=31),
    "wide": dict(N=24, num_nodes=1, angles_total=16, det_pixels=48,
                 det_width_factor=1.5),
}
FAN = dict(N=24, num_nodes=2, angles_total=64, fan_beam=True)


def _assert_tables_match(tt, tj):
    """Every port table against the JAX package's of the same name."""
    ft, fj = _flat(tt), _flat(tj)
    assert set(ft) == set(fj), set(ft) ^ set(fj)
    for k, got in ft.items():
        want = np.asarray(fj[k]).astype(np.float32)
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).split(".")[-1] == str(np.asarray(fj[k]).dtype), k
        g = got.float().numpy()
        tol = TABLE_RTOL * max(np.abs(want).max(), 1e-30)
        if got.dtype == torch.bfloat16:
            mag = np.maximum(np.maximum(np.abs(g), np.abs(want)), 1e-30)
            tol = tol + np.exp2(np.floor(np.log2(mag)) - 7)
        assert (np.abs(g - want) <= tol).all(), k


def _geos(**kw):
    t = tcfg.GeometryConfig(**kw)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _node(geo_t, i=0):
    a, v, _ = jradon.node_angles(jcfg.GeometryConfig(
        **dataclasses.asdict(geo_t)))
    a = np.asarray(a, np.float32)[i]
    v = np.asarray(v)[i]
    return torch.as_tensor(a), torch.as_tensor(v), jnp.asarray(a), \
        jnp.asarray(v)


def _tables(fan, geo, dtype_name, node=0):
    """(geometry, both packages' tables of one node, its angles)."""
    gt, gj = _geos(**(FAN if fan else PARALLEL[geo]))
    at, vt, aj, vj = _node(gt, node)
    jmod, tmod = (jfan, tfan) if fan else (jfft, tfft)
    jpre = jmod.precompute_fan if fan else jmod.precompute_phases
    tpre = tmod.precompute_fan if fan else tmod.precompute_phases
    tj = jax.jit(lambda a, v: jpre(gj, a, v, table_dtype=jnp.dtype(
        dtype_name)))(aj, vj)
    tt = tpre(gt, at, vt, table_dtype=getattr(torch, dtype_name))
    return gt, gj, tt, tj, (at, vt, aj, vj), (jmod, tmod)


CASES = [(False, "N24P3"), (False, "wide"), (True, None)]
IDS = ["parallel", "wide", "fan"]


@pytest.mark.parametrize("fan, geo", CASES, ids=IDS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tables_match_jax(fan, geo, dtype_name):
    _, _, tt, tj, _, _ = _tables(fan, geo, dtype_name, node=-1)
    _assert_tables_match(tt, tj)


@pytest.mark.parametrize("fan, geo", CASES, ids=IDS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_operators_match_jax(fan, geo, dtype_name):
    """project and backproject of the last node (a padded row in the
    parallel case) against JAX's, given the same tables."""
    gt, gj, tt, tj, (at, vt, aj, vj), (jmod, tmod) = _tables(
        fan, geo, dtype_name, node=-1)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((gt.N, gt.N)).astype(np.float32)
    want = np.asarray(jmod.project(gj, jnp.asarray(img), aj, vj, tj))
    got = tmod.project(gt, torch.as_tensor(img), at, vt, tt).numpy()
    tol = OP_RTOL[dtype_name]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    sino = rng.standard_normal(want.shape).astype(np.float32)
    want_t = np.asarray(jmod.backproject(gj, jnp.asarray(sino), aj, vj, tj))
    got_t = tmod.backproject(gt, torch.as_tensor(sino), at, vt, tt).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=0,
                               atol=tol * np.abs(want_t).max())
    lhs = float(np.sum(got.astype(np.float64) * sino))
    rhs = float(np.sum(img.astype(np.float64) * got_t))
    assert abs(lhs - rhs) <= ADJ_RTOL * np.linalg.norm(got) * np.linalg.norm(
        sino)


def test_padded_angles_masked():
    """A node's padded angle row projects to zeros (JAX's
    test_padded_angles_masked)."""
    gt = tcfg.GeometryConfig(N=16, num_nodes=3, angles_total=10)
    at, vt, _, _ = _node(gt, 1)
    assert not bool(vt[3])
    img = torch.as_tensor(np.random.default_rng(0).normal(
        size=(16, 16)).astype(np.float32))
    out = tfft.project(gt, img, at, vt)
    assert bool((out[3] == 0).all())
    assert bool((out[:3] != 0).any())


def test_wide_detector_window_is_alias_free(monkeypatch):
    """The window bound from the detector side: a 5x pad gives the same
    projection (the JAX test's tolerance, 2e-4)."""
    gt, _ = _geos(**PARALLEL["wide"])
    at, vt, _, _ = _node(gt)
    img = torch.as_tensor(np.random.default_rng(4).normal(
        size=(24, 24)).astype(np.float32))
    tight = tfft.project(gt, img, at, vt)
    monkeypatch.setattr(tfft, "_PAD_FACTOR", 5.0)
    wide = tfft.project(gt, img, at, vt)
    assert wide.shape == tight.shape
    np.testing.assert_allclose(tight.numpy(), wide.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("fan", [False, True], ids=["parallel", "fan"])
def test_node_batch_equals_single_nodes(fan):
    """The loader's node-batched operators on two images a node (a batch
    of P x 2, b-major, as ``run_admm_batched`` hands them) equal the
    single-node functions, to 1e-6 of the max (the FFTs and sums
    vectorize across the batch)."""
    geo = FAN if fan else PARALLEL["N24P3"]
    gt = tcfg.GeometryConfig(**geo)
    cfg = tcfg.ProblemConfig(geometry=gt)
    a, v, _ = jradon.node_angles(jcfg.GeometryConfig(**geo))
    at, vt = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(v)
    t = tloader.build_fft_tables(cfg, at, vt, "fft")
    fwd, adj = tloader.make_node_ops("fft", gt, t)
    P, N, D = gt.num_nodes, gt.N, gt.n_det
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2 * P, N * N), generator=gen)
    y = torch.randn((2 * P, at.shape[1] * D), generator=gen)
    mod = tfan if fan else tfft
    Ax, Aty = fwd(x), adj(y)
    for k in range(2 * P):
        i = k % P
        one = ({key: val[0] for key, val in t["shared"].items()} if fan
               else {key: val[i] for key, val in t.items()})
        got = mod.project(gt, x[k].reshape(N, N), at[i], vt[i], one)
        got_t = mod.backproject(gt, y[k].reshape(-1, D), at[i], vt[i], one)
        for a, b in ((Ax[k], got), (Aty[k], got_t)):
            torch.testing.assert_close(a, b.reshape(-1), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_fan_tables_kept_once():
    """Fan mode ``fft`` holds one node's tables once, a table batch of one
    under ``"shared"`` that the mesh's placement rule keeps whole, beside
    the per-node row mask; ``serialization._jax_layout`` repeats them over
    the nodes as JAX's vmap lays them out."""
    gt = tcfg.GeometryConfig(**FAN)
    a, v, _ = jradon.node_angles(jcfg.GeometryConfig(**FAN))
    t = tloader.build_fft_tables(tcfg.ProblemConfig(geometry=gt),
                                 torch.as_tensor(np.asarray(a, np.float32)),
                                 torch.as_tensor(v), "fft")
    P = gt.num_nodes
    assert set(t) == {"shared", "fan_valid"}
    assert {x.shape[0] for x in t["shared"].values()} == {1}
    specs = tmesh.table_specs(t, P)
    assert set(specs["shared"].values()) == {None}
    assert specs["fan_valid"] == tmesh.NODE_AXIS
    part = tmesh.slice_tables(t, P, slice(1, 2))
    assert all(part["shared"][k] is x for k, x in t["shared"].items())
    assert torch.equal(part["fan_valid"], t["fan_valid"][1:2])
    flat = tser._jax_layout(t, "fft")
    assert set(flat) == set(t["shared"]) | {"fan_valid"}
    for k, x in t["shared"].items():
        assert flat[k].shape == (P, *x.shape[1:])
        assert all(torch.equal(flat[k][i], x[0]) for i in range(P)), k


def _counts():
    return [k.launches for k in (
        shear_sum.skew_sum_planes, shear_sum.eval_shear,
        filter_sum.filter_sum_grouped, filter_sum.filter_sum_sel,
        consensus.consensus_update)]


def _cfg_jax(fan):
    geo = FAN if fan else dict(N=24, num_nodes=3, angles_total=31)
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(**geo),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(max_iters=3, eps_pri=0.0, eps_dual=0.0),
        phantom="shepp", fft_table_dtype="float32",
    )


@pytest.fixture(scope="module", params=[False, True], ids=["parallel", "fan"])
def fft_build(request):
    """A JAX mode-``fft`` problem and the port's own build of it, given
    JAX's noise draw and power-method start."""
    cfg_j = _cfg_jax(request.param)
    pj = jloader.build_problem(cfg_j, mode="fft")
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode="fft",
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    return cfg_j, pj, pt


def test_build_matches_jax(fft_build):
    _, pj, pt = fft_build
    assert pt.mode == pj.mode == "fft"
    scale = np.abs(np.asarray(pj.b)).max()
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), rtol=0,
                               atol=1e-5 * scale)
    for k in ("W", "Q"):
        want = np.asarray(getattr(pj, k))
        np.testing.assert_allclose(getattr(pt, k).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * want.max(), err_msg=k)
    np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep))
    np.testing.assert_array_equal(pt.adj.numpy(), np.asarray(pj.adj))
    np.testing.assert_allclose(pt.opnorm.numpy(), np.asarray(pj.opnorm),
                               rtol=1e-4)
    _assert_tables_match(tser._jax_layout(pt.fft_tables, "fft"),
                         pj.fft_tables)


def test_three_outers_match_jax(fft_build):
    """Three cv outers on the JAX problem's data with the port's own
    tables: states within 1e-4, histories within 1e-3, no kernel
    launched."""
    cfg_j, pj, pt = fft_build
    res_j = jadmm.run_admm(pj, cfg_j.admm)
    tp = dataclasses.replace(pt, **{
        k: torch.as_tensor(np.array(getattr(pj, k)))
        for k in ("b", "W", "Q", "keep", "adj", "x_true", "opnorm")})
    before = _counts()
    res_t = tadmm.run_admm(tp, tp.cfg.admm)
    assert _counts() == before
    scale = float(np.abs(np.asarray(res_j.x)).max())
    for got, want in ((res_t.x, res_j.x), (res_t.state.Z, res_j.state.Z),
                      (res_t.state.Y, res_j.state.Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL * scale)
    assert res_t.n_iters == int(res_j.n_iters) == 3
    for name, v in res_j.history.items():
        np.testing.assert_allclose(res_t.history[name].numpy(), np.asarray(v),
                                   rtol=HIST_RTOL, atol=ATOL, err_msg=name)


def test_bundles_both_ways(fft_build, tmp_path):
    """A JAX mode-``fft`` bundle loads into the port with its tables, and
    the port's bundle loads into JAX with the same arrays."""
    _, pj, pt = fft_build
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_problem(pj, jpath)
    got = tser.load_problem(jpath, "cpu")
    assert got.mode == "fft"
    _assert_tables_match(tser._jax_layout(got.fft_tables, "fft"),
                         pj.fft_tables)
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(pj.b))
    tser.save_problem(pt, tpath)
    back = jser.load_problem(tpath)
    assert back.mode == "fft"
    np.testing.assert_array_equal(np.asarray(back.b), pt.b.numpy())
    _assert_tables_match(tser._jax_layout(pt.fft_tables, "fft"),
                         back.fft_tables)
    x = np.random.default_rng(2).standard_normal(
        (pt.num_nodes, pt.n)).astype(np.float32)
    fwd_j, _ = jloader.make_node_ops("fft", back.cfg.geometry, back.angles,
                                     back.angle_valid, None, back.fft_tables)
    want = np.asarray(fwd_j(jnp.asarray(x)))
    np.testing.assert_allclose(pt.forward(torch.as_tensor(x)).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


def test_cli_matrix_free_forces_fft():
    """``--matrix-free`` picks mode fft where ``--mode`` is auto (JAX's
    ``mode_from_args``); an explicit ``--mode`` wins."""
    from dip_admm_tpu_torch.runners import cli

    parser = cli.build_parser()
    for argv, want in ((["--matrix-free"], "fft"), (["--mode", "fft"], "fft"),
                       (["--matrix-free", "--mode", "dense"], "dense"),
                       ([], None)):
        args = parser.parse_args(["--device", "cpu", *argv])
        assert cli.mode_from_args(args) == want, argv
