"""Fan beam and ``fft_grouped`` in the PyTorch port against the JAX package,
on the CPU, at small sizes (fan N = 24-32 with 2-4 nodes and 64 fan
angles; parallel N = 32 with 3 nodes), on numpy-seeded inputs.

Tolerances: tables to 1e-5 of their max in f32 (the rebin geometry and the
phases round to float32 as XLA does; an ulp is ~6e-8 here) and to one bf16
ulp in bf16, integer and plane fields equal; operators to 1e-4 of the
output's max with f32 tables and 2e-3 with bf16 tables (sums in another
order; a bf16 rounding of an intermediate can land on the other side);
the adjoint identity to 1e-5 relative; the problem build and the ADMM
histories as in ``test_torch_admm.py``. On the CPU every kernel wrapper runs
its plain version; the CUDA kernels are held to those on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.ops import radon_fan as jfan
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fan as tfan
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import shear_sum as tss

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
TABLE_RTOL = 1e-5
INT_KEYS = {"plane", "pfirst", "pvisited", "posfull", "invposfull", "onehot",
            "fan_valid"}
# Fan geometries: the default detector (the bench workload's) and the wide
# one of the JAX package's fan tests.
FAN = {
    "N32P4": dict(N=32, num_nodes=4, angles_total=64),
    "N24P2wide": dict(N=24, num_nodes=2, angles_total=64,
                      det_width_factor=2.0),
}


def _geos(**kw):
    t = tcfg.GeometryConfig(**kw)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _angles(geo_t):
    a, v, _ = tradon.node_angles(geo_t)
    return (torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
            jnp.asarray(a, jnp.float32), jnp.asarray(v))


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _assert_tables_match(tt, tj):
    """Every port table equals the JAX package's table of the same name
    (the JAX package keeps a few more, for paths the port does not run)."""
    ft, fj = _flat(tt), _flat(tj)
    assert set(ft) <= set(fj), set(ft) - set(fj)
    for k, got in ft.items():
        want = np.asarray(fj[k])
        assert tuple(got.shape) == want.shape, k
        if k.rsplit("/", 1)[-1] in INT_KEYS:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        elif want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16, k
            g = got.float().numpy()
            w = want.astype(np.float32)
            mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
            ulp = np.exp2(np.floor(np.log2(mag)) - 7)
            assert (np.abs(g - w) <= ulp * (1 + 1e-6)).all(), k
        else:
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=TABLE_RTOL * max(np.abs(want).max(), 1e-30), err_msg=k)


def _fan_tables(mode, dtype_name, geo="N32P4"):
    gt, gj = _geos(fan_beam=True, **FAN[geo])
    at, vt, aj, vj = _angles(gt)
    pre = "precompute_fan_" + mode
    tt = getattr(tfan, pre)(gt, at, vt, getattr(torch, dtype_name))
    tj = getattr(jfan, pre)(gj, aj, vj, jnp.dtype(dtype_name))
    return gt, gj, tt, tj


def _parallel_grouped_tables(dtype_name):
    gt, gj = _geos(N=32, num_nodes=3, angles_total=30)
    at, vt, aj, vj = _angles(gt)
    tt = tfft.precompute_grouped(gt, at, vt, getattr(torch, dtype_name))
    tj = jfft.precompute_grouped(gj, aj, vj, jnp.dtype(dtype_name))
    return gt, gj, tt, tj


def _inputs(geo_t, seed=0):
    rng = np.random.default_rng(seed)
    P, N = geo_t.num_nodes, geo_t.N
    m = max(geo_t.angles_per_node())
    return (rng.standard_normal((P, N, N)).astype(np.float32),
            rng.standard_normal((P, m, geo_t.n_det)).astype(np.float32))


def _adjoint_rel(fwd, adj, x, y):
    Ax = fwd(torch.as_tensor(x))
    Aty = adj(torch.as_tensor(y))
    lhs = float(torch.sum(Ax.double() * torch.as_tensor(y).double()))
    rhs = float(torch.sum(torch.as_tensor(x).double() * Aty.double()))
    return abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                  * np.linalg.norm(y))


# ---------------------------------------------------------------------------
# K1-K4 with one table set shared by all images (PT = 1)
# ---------------------------------------------------------------------------


def _skew_cases(t, P, seed=0):
    sh = t["shared"]
    _, NB, D2, Tp, nb = t["WtT"].shape
    N, F = NB * nb, t["SEre"].shape[-1]
    D = t["Wd"].shape[1] * t["Wd"].shape[-1]
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn((P, N, N), generator=gen)
    rows2 = torch.stack([img, img.transpose(1, 2)], dim=1)
    g, g2 = (torch.randn((P, Tp, F), generator=gen) for _ in range(2))
    ob = torch.randn((P, Tp, D), generator=gen)
    return {
        "skew_sum_planes": (tss.skew_sum_planes_ref, (rows2,), (
            t["WtT"], t["SEre"], t["SEim"], sh["Dre"], sh["Dim"],
            t["plane"])),
        "skew_sum_planes_t": (tss.skew_sum_planes_t_ref, (g, g2), (
            t["WtT"], t["SEre"], t["SEim"], sh["DreT"], sh["DimT"],
            t["plane"])),
        "eval_shear": (tss.eval_shear_ref, (g, g2), (
            t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"])),
        "eval_shear_t": (tss.eval_shear_t_ref, (ob,), (
            t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"])),
    }


@pytest.mark.parametrize("name", ["skew_sum_planes", "skew_sum_planes_t",
                                  "eval_shear", "eval_shear_t"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_skew_kernels_shared_table_fold(name, dtype_name):
    """Three images against the one shared fan table set equal three
    single-image calls."""
    gt = tcfg.GeometryConfig(fan_beam=True, **FAN["N32P4"])
    at, vt, _, _ = _angles(gt)
    t = tfan.precompute_fan_skew(gt, at, vt, getattr(torch, dtype_name),
                                 nb=16)["shared"]["par"]
    assert t["WtT"].shape[:2] == (1, 2)  # PT = 1, two row blocks
    ref, imgs, tabs = _skew_cases(t, 3)[name]
    got = ref(*imgs, *tabs)
    got = got if isinstance(got, tuple) else (got,)
    for p in range(3):
        one = ref(*(x[p:p + 1] for x in imgs), *tabs)
        one = one if isinstance(one, tuple) else (one,)
        for a, b in zip(got, one):
            _close(a[p:p + 1], b, 1e-6)


def test_skew_wrappers_reject_a_table_batch_that_does_not_divide():
    gt = tcfg.GeometryConfig(N=32, num_nodes=2, angles_total=30)
    at, vt, _, _ = _angles(gt)
    t = tfft.precompute_shear(gt, at, vt, nb=16)
    ref, imgs, tabs = _skew_cases(t, 3)["eval_shear"]
    with pytest.raises(ValueError):
        ref(*imgs, *tabs)  # 3 images, 2 table sets


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["skew", "grouped"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fan_tables_match_jax(mode, dtype_name):
    _, _, tt, tj = _fan_tables(mode, dtype_name)
    _assert_tables_match(tt, tj)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_tables_match_jax(dtype_name):
    _, _, tt, tj = _parallel_grouped_tables(dtype_name)
    assert tt["Hre_g"].shape[0] == 3  # one table set per node
    _assert_tables_match(tt, tj)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["skew", "grouped"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fan_operators_match_jax(mode, dtype_name):
    gt, gj, tt, tj = _fan_tables(mode, dtype_name)
    x, y = _inputs(gt)
    rtol = OP_RTOL[dtype_name]
    _close(getattr(tfan, f"project_nodes_fan_{mode}")(
        gt, torch.as_tensor(x), tt),
        getattr(jfan, f"project_nodes_fan_{mode}")(gj, jnp.asarray(x), tj),
        rtol)
    _close(getattr(tfan, f"backproject_nodes_fan_{mode}")(
        gt, torch.as_tensor(y), tt),
        getattr(jfan, f"backproject_nodes_fan_{mode}")(gj, jnp.asarray(y),
                                                        tj),
        rtol)


@pytest.mark.parametrize("mode", ["skew", "grouped"])
@pytest.mark.parametrize("geo", list(FAN))
def test_fan_adjoint_identity(mode, geo):
    gt, _, tt, _ = _fan_tables(mode, "float32", geo)
    x, y = _inputs(gt, seed=1)
    rel = _adjoint_rel(
        lambda v: getattr(tfan, f"project_nodes_fan_{mode}")(gt, v, tt),
        lambda v: getattr(tfan, f"backproject_nodes_fan_{mode}")(gt, v, tt),
        x, y)
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_parallel_grouped_operators_match_jax(dtype_name):
    gt, gj, tt, tj = _parallel_grouped_tables(dtype_name)
    x, y = _inputs(gt)
    rtol = OP_RTOL[dtype_name]
    _close(tfft.project_nodes_grouped(gt, torch.as_tensor(x), tt),
           jfft.project_nodes_grouped(gj, jnp.asarray(x), tj), rtol)
    _close(tfft.backproject_nodes_grouped(gt, torch.as_tensor(y), tt),
           jfft.backproject_nodes_grouped(gj, jnp.asarray(y), tj), rtol)
    if dtype_name == "float32":
        rel = _adjoint_rel(
            lambda v: tfft.project_nodes_grouped(gt, v, tt),
            lambda v: tfft.backproject_nodes_grouped(gt, v, tt), x, y)
        assert rel <= 1e-5, rel


def test_parallel_grouped_equals_skew():
    """Both ported parallel projectors apply the same operator."""
    gt = tcfg.GeometryConfig(N=32, num_nodes=3, angles_total=30)
    at, vt, _, _ = _angles(gt)
    tg = tfft.precompute_grouped(gt, at, vt)
    ts = tfft.precompute_shear(gt, at, vt, nb=16)
    x, y = _inputs(gt, seed=2)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    _close(tfft.project_nodes_grouped(gt, x, tg),
           tfft.project_nodes_skew(gt, x, ts).numpy(), 1e-5)
    _close(tfft.backproject_nodes_grouped(gt, y, tg),
           tfft.backproject_nodes_skew(gt, y, ts).numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Column norms, problem build and the loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True])
def test_colnorms_sq_nodes_matches_jax(ragged):
    gt, gj = _geos(fan_beam=True, **FAN["N32P4"])
    at, vt, aj, vj = _angles(gt)
    if ragged:  # node 1 loses its last 5 fan rows
        v = np.asarray(vj).copy()
        v[1, -5:] = False
        vt, vj = torch.as_tensor(v), jnp.asarray(v)
    got = tfan.colnorms_sq_nodes(gt, at, vt).numpy()
    want = np.asarray(jfan.colnorms_sq_nodes(gj, aj, vj))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _cfg_jax(mode_geo="N32P4", **admm_over):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(fan_beam=True, **FAN[mode_geo]),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(max_iters=3, eps_pri=0.0, eps_dual=0.0,
                             **admm_over),
        phantom="shepp", fft_table_dtype="float32",
    )


def _port_cfg(cfg_j):
    d = dataclasses.asdict(cfg_j)
    return tcfg.ProblemConfig(
        geometry=tcfg.GeometryConfig(**d["geometry"]),
        graph=tcfg.GraphConfig(**d["graph"]),
        admm=tcfg.AdmmConfig(**{**d["admm"],
                                "node": tcfg.NodeSolverConfig(**d["admm"]["node"])}),
        **{k: v for k, v in d.items() if k not in ("geometry", "graph", "admm")},
    )


@pytest.fixture(scope="module", params=["fft_skew", "fft_grouped"])
def fan_build(request):
    """A JAX fan problem and the port's own build of it, given JAX's noise
    draw and power-method start."""
    mode = request.param
    cfg_j = _cfg_jax()
    pj = jloader.build_problem(cfg_j, mode=mode)
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode=mode,
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    return mode, cfg_j, pj, pt


def test_fan_build_matches_jax(fan_build):
    mode, _, pj, pt = fan_build
    assert pt.mode == pj.mode == mode
    scale = np.abs(np.asarray(pj.b)).max()
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(pt.W.numpy(), np.asarray(pj.W), rtol=1e-5,
                               atol=1e-5 * np.asarray(pj.W).max())
    np.testing.assert_allclose(pt.Q.numpy(), np.asarray(pj.Q), rtol=1e-5,
                               atol=1e-5 * np.asarray(pj.Q).max())
    np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep))
    np.testing.assert_array_equal(pt.adj.numpy(), np.asarray(pj.adj))
    np.testing.assert_allclose(pt.opnorm.numpy(), np.asarray(pj.opnorm),
                               rtol=1e-4)


RECOMMENDED = dict(relax_alpha=1.8, use_pallas=True,
                   node=dict(algorithm="fcv", max_inner=15, check_every=15))
RTOL, ATOL, FCV_HIST_RTOL = 1e-4, 1e-5, 1e-3  # as in test_torch_admm.py


def _over(admm_cfg, over):
    over = dict(over)
    node = dataclasses.replace(admm_cfg.node, **over.pop("node", {}))
    return dataclasses.replace(admm_cfg, node=node, **over)


def test_fan_recommended_three_outers_match_jax(fan_build):
    """Three outers of the recommended preset on the JAX problem's data
    (b, W, Q, graph, opnorm, as a loaded bundle carries them) with the
    port's own tables and JAX's Lanczos start."""
    mode, cfg_j, pj, pt = fan_build
    res_j = jadmm.run_admm(pj, _over(cfg_j.admm, RECOMMENDED))
    tp = dataclasses.replace(pt, **{
        k: torch.as_tensor(np.array(getattr(pj, k)))
        for k in ("b", "W", "Q", "keep", "adj", "x_true", "opnorm")})
    n = cfg_j.geometry.n
    v0 = torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (n,), jnp.float32)))
    res_t = tadmm.run_admm(tp, _over(tp.cfg.admm, RECOMMENDED),
                           lanczos_v0=v0)
    scale = float(np.abs(np.asarray(res_j.x)).max())
    for got, want in ((res_t.x, res_j.x), (res_t.state.Z, res_j.state.Z),
                      (res_t.state.Y, res_j.state.Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL * scale)
    assert res_t.n_iters == int(res_j.n_iters) == 3
    for name in ("inner_iters", "accept_code"):
        np.testing.assert_array_equal(res_t.history[name].numpy(),
                                      np.asarray(res_j.history[name]))
    for name, v in res_j.history.items():
        np.testing.assert_allclose(res_t.history[name].numpy(), np.asarray(v),
                                   rtol=FCV_HIST_RTOL, atol=ATOL,
                                   err_msg=name)


def test_fan_mode_none_resolves_to_fft_skew():
    """The JAX loader's rule for fan beam: mode=None is fft_skew above
    N = 128 (the rule alone; nothing is built there) and dense at
    N <= 128, which the build takes."""
    for N, want in ((129, "fft_skew"), (256, "fft_skew"), (128, "dense"),
                    (24, "dense")):
        geo = tcfg.GeometryConfig(N=N, num_nodes=2, fan_beam=True)
        assert tloader.resolve_mode(geo) == want, N
    cfg = _port_cfg(_cfg_jax("N24P2wide"))
    p = tloader.build_problem(cfg, "cpu")
    assert p.mode == "dense"
    assert p.b.shape == (2, 32 * 24) and torch.isfinite(p.W).all()


@pytest.mark.parametrize("mode", ["fft_pallas", "fft_mxu", "fft_shear"])
def test_unported_modes_raise(mode):
    cfg = _port_cfg(_cfg_jax("N24P2wide"))
    with pytest.raises(NotImplementedError):
        tloader.build_problem(cfg, "cpu", mode=mode)
