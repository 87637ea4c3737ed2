"""The ``fft_pallas`` projector mode of the PyTorch port against the JAX
package, on the CPU, on numpy-seeded inputs: the select filter-sum kernels
K11/K12 (their plain versions against the JAX Pallas kernels in interpret
mode), the node-batched merged tables, the operator pair, the problem build
and three outers of the recommended preset (parallel beam, N = 16-32 with
3 nodes).

Tolerances: the kernels to 1e-5 of the output's max with f32 and with bf16
tables (a bf16 table is upcast exactly and every product and sum is f32 on
both sides; only the order of the sums differs); tables to 1e-5 of their
max in f32 and to one bf16 ulp in bf16; operators to 1e-4 of the output's
max with f32 tables and 2e-3 with bf16 tables (sums in another order; a
bf16 rounding of an intermediate can land on the other side); the adjoint
identity to 1e-5 relative; the build and the ADMM histories as in
``test_torch_fan.py``. On the CPU every kernel wrapper runs its plain
version; the CUDA kernels are held to those on the card."""

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
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import filter_sum as jfs
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_RTOL = 1e-5
OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
TABLE_RTOL = 1e-5
T, N, F = 12, 24, 65  # angles, rows, frequencies of the kernel tests


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# K11/K12
# ---------------------------------------------------------------------------


def _sel_tables(dtype_name, PT, seed=0):
    """H pair and selector of PT table sets: set 0 takes every angle from
    plane 0, set 1 (if any) every angle from plane 1 (single-branch nodes),
    the others a random mix."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((2, PT, T, N, F)).astype(np.float32)
    sel = (rng.random((PT, T, 1)) > 0.5).astype(np.float32)
    sel[0] = 0.0
    if PT > 1:
        sel[1] = 1.0
    Hj = jnp.asarray(H).astype(jnp.dtype(dtype_name))
    Ht = torch.as_tensor(H).to(getattr(torch, dtype_name))
    return (Hj[0], Hj[1], jnp.asarray(sel)), (Ht[0], Ht[1],
                                             torch.as_tensor(sel))


# (images, table sets): one table set per image, and three images per set
# (JAX: jax.vmap over the images, whose rule folds them into the node axis).
BATCHES = [(3, 3), (9, 3)]


def _jax_batched(fn, x, PB, PT):
    """fn over PB images [PB, ...] against PT table sets, as the JAX package
    runs it: directly when PB = PT, else vmapped over PB // PT groups."""
    if PB == PT:
        return fn(*x)
    xs = [a.reshape((PB // PT, PT) + a.shape[1:]) for a in x]
    out = jax.vmap(fn)(*xs)
    return [np.asarray(o).reshape((PB,) + o.shape[2:]) for o in out]


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_sel_matches_jax(dtype_name, batch):
    PB, PT = batch
    (hj, hij, sj), (ht, hit, st) = _sel_tables(dtype_name, PT)
    r = np.random.default_rng(1).standard_normal((2, PB, 2, N, F)).astype(
        np.float32)
    want = _jax_batched(lambda a, b: jfs.filter_sum_sel(a, b, hj, hij, sj),
                        [jnp.asarray(r[0]), jnp.asarray(r[1])], PB, PT)
    got = tfs.filter_sum_sel(torch.as_tensor(r[0]), torch.as_tensor(r[1]),
                             ht, hit, st)
    for g, w in zip(got, want):
        assert g.shape == (PB, T, F)
        _close(g, w, KERNEL_RTOL)
    if PB == PT:  # the plain reference of the JAX package gives the same
        for g, w in zip(got, jfs.filter_sum_sel_reference(
                jnp.asarray(r[0]), jnp.asarray(r[1]), hj, hij, sj)):
            _close(g, w, KERNEL_RTOL)


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_sel_t_matches_jax(dtype_name, batch):
    PB, PT = batch
    (hj, hij, sj), (ht, hit, st) = _sel_tables(dtype_name, PT)
    g = np.random.default_rng(2).standard_normal((2, PB, T, F)).astype(
        np.float32)
    want = _jax_batched(lambda a, b: jfs.filter_sum_sel_t(a, b, hj, hij, sj),
                        [jnp.asarray(g[0]), jnp.asarray(g[1])], PB, PT)
    got = tfs.filter_sum_sel_t(torch.as_tensor(g[0]), torch.as_tensor(g[1]),
                               ht, hit, st)
    for a, w in zip(got, want):
        assert a.shape == (PB, 2, N, F)
        _close(a, w, KERNEL_RTOL)
        # The single-branch table sets leave the other plane exactly zero.
        for p in range(PB):
            if p % PT < 2:
                unread = 1 - p % PT
                assert torch.equal(a[p, unread], torch.zeros_like(a[p, 0]))


def test_sel_pair_is_a_transpose():
    """<K11 r, g> = <r, K12 g> with three images per table set."""
    (_, _, _), (ht, hit, st) = _sel_tables("float32", 3)
    gen = torch.Generator().manual_seed(5)
    r = torch.randn((2, 9, 2, N, F), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 9, T, F), generator=gen, dtype=torch.float64)
    Kr = tfs.filter_sum_sel(r[0].float(), r[1].float(), ht, hit, st)
    Ktg = tfs.filter_sum_sel_t(g[0].float(), g[1].float(), ht, hit, st)
    lhs = sum(float((a.double() * b).sum()) for a, b in zip(Kr, g))
    rhs = sum(float((a * b.double()).sum()) for a, b in zip(r, Ktg))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_sel_cpu_path_counts_no_launch():
    (_, _, _), (ht, hit, st) = _sel_tables("float32", 1)
    tfs.reset_launch_counts()
    tfs.filter_sum_sel(torch.zeros((2, 2, N, F)), torch.zeros((2, 2, N, F)),
                       ht, hit, st)
    tfs.filter_sum_sel_t(torch.zeros((2, T, F)), torch.zeros((2, T, F)), ht,
                         hit, st)
    assert tfs.filter_sum_sel.launches == tfs.filter_sum_sel_t.launches == 0


def test_sel_rejects_a_table_batch_that_does_not_divide():
    (_, _, _), (ht, hit, st) = _sel_tables("float32", 2)
    with pytest.raises(ValueError):  # 3 images, 2 table sets
        tfs.filter_sum_sel(torch.zeros((3, 2, N, F)),
                           torch.zeros((3, 2, N, F)), ht, hit, st)


# ---------------------------------------------------------------------------
# Tables and operators
# ---------------------------------------------------------------------------

# The second geometry is the JAX package's own fft_pallas test size.
GEOS = {"N32P3": dict(N=32, num_nodes=3, angles_total=30),
        "N16P3": dict(N=16, num_nodes=3, angles_total=24)}


def _geos(**kw):
    t = tcfg.GeometryConfig(**kw)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _merged_tables(dtype_name, geo="N32P3"):
    gt, gj = _geos(**GEOS[geo])
    a, v, _ = tradon.node_angles(gt)
    tt = tfft.precompute_merged_nodes(
        gt, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        getattr(torch, dtype_name), pitched=True)  # the fft_pallas build
    tj = jax.jit(jax.vmap(lambda aa, vv: jfft.precompute_merged(
        gj, aa, vv, table_dtype=jnp.dtype(dtype_name))))(
        jnp.asarray(a, jnp.float32), jnp.asarray(v))
    return gt, gj, tt, tj


def _inputs(geo_t, seed=0):
    rng = np.random.default_rng(seed)
    P, n = geo_t.num_nodes, geo_t.N
    m = max(geo_t.angles_per_node())
    return (rng.standard_normal((P, n, n)).astype(np.float32),
            rng.standard_normal((P, m, geo_t.n_det)).astype(np.float32))


@pytest.mark.parametrize("geo", list(GEOS))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_merged_tables_match_jax(dtype_name, geo):
    _, _, tt, tj = _merged_tables(dtype_name, geo)
    assert set(tt) == set(tj)
    for k, got in tt.items():
        want = np.asarray(tj[k])
        assert tuple(got.shape) == want.shape, k
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16, k
            g, w = got.float().numpy(), want.astype(np.float32)
            mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
            ulp = np.exp2(np.floor(np.log2(mag)) - 7)
            assert (np.abs(g - w) <= ulp * (1 + 1e-6)).all(), k
        elif k == "sel":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=TABLE_RTOL * max(np.abs(want).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("geo", list(GEOS))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pallas_operators_match_jax(dtype_name, geo):
    gt, gj, tt, tj = _merged_tables(dtype_name, geo)
    x, y = _inputs(gt)
    rtol = OP_RTOL[dtype_name]
    _close(tfft.project_nodes_merged(gt, torch.as_tensor(x), tt),
           jfft.project_nodes_merged(gj, jnp.asarray(x), tj), rtol)
    _close(tfft.backproject_nodes_merged(gt, torch.as_tensor(y), tt),
           jfft.backproject_nodes_merged(gj, jnp.asarray(y), tj), rtol)


@pytest.mark.parametrize("geo", list(GEOS))
def test_pallas_adjoint_identity(geo):
    gt, _, tt, _ = _merged_tables("float32", geo)
    x, y = _inputs(gt, seed=1)
    Ax = tfft.project_nodes_merged(gt, torch.as_tensor(x), tt)
    Aty = tfft.backproject_nodes_merged(gt, torch.as_tensor(y), tt)
    lhs = float(torch.sum(Ax.double() * torch.as_tensor(y).double()))
    rhs = float(torch.sum(torch.as_tensor(x).double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                 * np.linalg.norm(y))
    assert rel <= 1e-5, rel


def test_pallas_equals_skew_and_grouped():
    """The three ported parallel projectors apply the same operator."""
    gt, _, tm, _ = _merged_tables("float32")
    a, v, _ = tradon.node_angles(gt)
    at, vt = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v)
    ts = tfft.precompute_shear(gt, at, vt, nb=16)
    tg = tfft.precompute_grouped(gt, at, vt)
    x, y = (torch.as_tensor(u) for u in _inputs(gt, seed=2))
    fwd = tfft.project_nodes_merged(gt, x, tm)
    adj = tfft.backproject_nodes_merged(gt, y, tm)
    for other in (tfft.project_nodes_skew(gt, x, ts),
                  tfft.project_nodes_grouped(gt, x, tg)):
        _close(fwd, other.numpy(), 1e-5)
    for other in (tfft.backproject_nodes_skew(gt, y, ts),
                  tfft.backproject_nodes_grouped(gt, y, tg)):
        _close(adj, other.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Problem build, the loop, and what is rejected
# ---------------------------------------------------------------------------


def _cfg_jax():
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(**GEOS["N32P3"]),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(max_iters=3, eps_pri=0.0, eps_dual=0.0),
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


@pytest.fixture(scope="module")
def pallas_build():
    """A JAX fft_pallas problem and the port's own build of it, given JAX's
    noise draw and power-method start."""
    cfg_j = _cfg_jax()
    pj = jloader.build_problem(cfg_j, mode="fft_pallas")
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode="fft_pallas",
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    return cfg_j, pj, pt


def test_pallas_build_matches_jax(pallas_build):
    _, pj, pt = pallas_build
    assert pt.mode == pj.mode == "fft_pallas"
    scale = np.abs(np.asarray(pj.b)).max()
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), rtol=0,
                               atol=1e-5 * scale)
    for k in ("W", "Q"):
        want = np.asarray(getattr(pj, k))
        np.testing.assert_allclose(getattr(pt, k).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * want.max())
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


def test_pallas_recommended_three_outers_match_jax(pallas_build):
    """Three outers of the recommended preset on the JAX problem's data
    (b, W, Q, graph, opnorm, as a loaded bundle carries them) with the
    port's own tables and JAX's Lanczos start."""
    cfg_j, pj, pt = pallas_build
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


def test_pallas_rejects_fan_beam():
    geo = tcfg.GeometryConfig(N=24, num_nodes=2, angles_total=64,
                              fan_beam=True)
    cfg = tcfg.ProblemConfig(geometry=geo, phantom="shepp")
    with pytest.raises(NotImplementedError, match="parallel beam only"):
        tloader.build_problem(cfg, "cpu", mode="fft_pallas")
    with pytest.raises(NotImplementedError, match="parallel beam only"):
        tloader.make_node_ops("fft_pallas", geo, {})
    x = torch.zeros((2, 24, 24))
    for fn in (tfft.project_nodes_merged, tfft.backproject_nodes_merged):
        with pytest.raises(NotImplementedError, match="parallel beam only"):
            fn(geo, x, {})
