"""The ``fft_mxu`` projector mode of the PyTorch port against the JAX
package, on the CPU, on numpy-seeded inputs: the row tile and the tiled
table layout, the tiled filter-sum kernels K15/K16 (their plain versions
against the JAX Pallas kernels in interpret mode, with two frequency tiles
and three row tiles: FB = 2, NB = 3), the node-batched tiled tables, the
operator pair and the adjoint identity, the problem build, a loaded JAX
bundle, and three outers of the recommended preset on that bundle and on
the port's own build (parallel beam, N = 32 with 3 nodes).

Tolerances: the kernels to 1e-5 of the output's max with f32 and with bf16
tables (a bf16 table is upcast exactly; K15 rounds the spectra to bf16 at
the same point as the JAX kernel, so every product is exact and only the
order of the f32 sums differs); the layouts exactly; tables to 1e-5 of
their max in f32 and to one bf16 ulp in bf16; operators to 1e-4 of the
output's max with f32 tables and 2e-3 with bf16 tables; the adjoint
identity to 1e-5 relative; the build and the ADMM histories as in
``test_torch_fft_pallas.py``. On the CPU every kernel wrapper runs its plain
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
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import filter_mxu as jmxu
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import filter_mxu as tmxu

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_RTOL = 1e-5
OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
TABLE_RTOL = 1e-5
# Kernel shapes: table sets, angles, slot blocks of tt slots, rows, row tile,
# frequencies (padded to 256: two 128-frequency tiles).
PT, T, TB, TT, N, TN, F = 3, 13, 2, 8, 24, 8, 200
FPAD = 256


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _to_torch(a):
    a = np.array(a)  # a writable copy
    if a.dtype == ml_dtypes.bfloat16:
        return torch.as_tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


# ---------------------------------------------------------------------------
# Layout, K15/K16
# ---------------------------------------------------------------------------


def _src_slot(seed=0):
    """A slot order of T angles in TB*TT slots per set, three slack slots."""
    rng = np.random.default_rng(seed)
    src = np.full((PT, TB * TT), -1, np.int32)
    for i in range(PT):
        slots = rng.permutation(TB * TT)[:T]
        src[i, slots] = np.arange(T)
    return src


def _mxu_tables(dtype_name, seed=0):
    """A random H pair [PT, T, N, F] tiled by the JAX package and by the
    port (the port's must equal it): (JAX pair, torch pair)."""
    H = np.random.default_rng(seed).standard_normal(
        (2, PT, T, N, F)).astype(np.float32)
    src = _src_slot(seed)
    jt = [jmxu.tile_table(jnp.asarray(h).astype(jnp.dtype(dtype_name)),
                          jnp.asarray(src), FPAD, TN) for h in H]
    tt = [tmxu.tile_table(torch.as_tensor(h).to(getattr(torch, dtype_name)),
                          torch.as_tensor(src), FPAD, TN) for h in H]
    return jt, tt


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tile_table_and_pick_tn_match_jax(dtype_name):
    for n in (8, 16, 24, 32, 40, 256, 512, 36):
        assert tmxu.pick_tn(n) == jmxu.pick_tn(n), n
    jt, tt = _mxu_tables(dtype_name)
    for j, t in zip(jt, tt):
        assert tuple(t.shape) == (PT, FPAD // 128, N // TN, TB * TT, TN * 128)
        np.testing.assert_array_equal(_to_torch(j).float().numpy(),
                                      t.float().numpy())
        # untile is the inverse layout: padded columns and slack rows zero
        h = tmxu.untile_table(t)
        assert tuple(h.shape) == (PT, TB * TT, N, FPAD)
        assert (h[..., F:] == 0).all()
        assert (h[torch.as_tensor(_src_slot()) < 0] == 0).all()


BATCHES = [(3, 3), (9, 3)]


def _jax_batched(fn, x, PB, PT_):
    if PB == PT_:
        return fn(*x)
    xs = [a.reshape((PB // PT_, PT_) + a.shape[1:]) for a in x]
    out = jax.vmap(fn)(*xs)
    return [np.asarray(o).reshape((PB,) + o.shape[2:]) for o in out]


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_filter_sum_mxu_matches_jax(dtype_name, batch):
    PB, _ = batch
    (hj, hij), (ht, hit) = _mxu_tables(dtype_name)
    r = np.random.default_rng(1).standard_normal(
        (2, PB, TB, N, FPAD)).astype(np.float32)
    want = _jax_batched(lambda a, b: jmxu.filter_sum_mxu(a, b, hj, hij),
                        [jnp.asarray(r[0]), jnp.asarray(r[1])], PB, PT)
    got = tmxu.filter_sum_mxu(torch.as_tensor(r[0]), torch.as_tensor(r[1]),
                              ht, hit)
    for g, w in zip(got, want):
        assert g.shape == (PB, TB * TT, FPAD)
        _close(g, w, KERNEL_RTOL)
    if PB == PT and dtype_name == "float32":
        # the JAX package's plain reference (it does not round the spectra)
        for g, w in zip(got, jmxu.filter_sum_mxu_reference(
                jnp.asarray(r[0]), jnp.asarray(r[1]), hj, hij)):
            _close(g, w, KERNEL_RTOL)


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_filter_sum_mxu_t_matches_jax(dtype_name, batch):
    PB, _ = batch
    (hj, hij), (ht, hit) = _mxu_tables(dtype_name)
    g = np.random.default_rng(2).standard_normal(
        (2, PB, TB * TT, FPAD)).astype(np.float32)
    blk = jnp.zeros((PT, TB, 2))
    want = _jax_batched(
        lambda a, b: jmxu.filter_sum_mxu_t(a, b, hj, hij, blk),
        [jnp.asarray(g[0]), jnp.asarray(g[1])], PB, PT)
    got = tmxu.filter_sum_mxu_t(torch.as_tensor(g[0]), torch.as_tensor(g[1]),
                                ht, hit, TB)
    for a, w in zip(got, want):
        assert a.shape == (PB, TB, N, FPAD)
        _close(a, w, KERNEL_RTOL)


def test_mxu_padding_and_slack_come_out_zero():
    """The padded frequencies and the slack slots of the forward, and the
    padded frequencies of the transpose, are exactly zero."""
    _, (ht, hit) = _mxu_tables("bfloat16")
    gen = torch.Generator().manual_seed(3)
    r = torch.randn((2, 6, TB, N, FPAD), generator=gen)
    gre, gim = tmxu.filter_sum_mxu(r[0], r[1], ht, hit)
    slack = torch.as_tensor(_src_slot()).repeat(2, 1) < 0
    for g in (gre, gim):
        assert (g[..., F:] == 0).all() and (g[slack] == 0).all()
        assert float(g.abs().max()) > 0
    gb = torch.randn((2, 6, TB * TT, FPAD), generator=gen)
    for a in tmxu.filter_sum_mxu_t(gb[0], gb[1], ht, hit, TB):
        assert (a[..., F:] == 0).all() and float(a.abs().max()) > 0


def test_mxu_pair_is_a_transpose():
    """<K15 r, g> = <r, K16 g> with three images per table set, f32."""
    _, (ht, hit) = _mxu_tables("float32")
    gen = torch.Generator().manual_seed(5)
    r = torch.randn((2, 9, TB, N, FPAD), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 9, TB * TT, FPAD), generator=gen, dtype=torch.float64)
    Kr = tmxu.filter_sum_mxu(r[0].float(), r[1].float(), ht, hit)
    Ktg = tmxu.filter_sum_mxu_t(g[0].float(), g[1].float(), ht, hit, TB)
    lhs = sum(float((a.double() * b).sum()) for a, b in zip(Kr, g))
    rhs = sum(float((a * b.double()).sum()) for a, b in zip(r, Ktg))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_mxu_cpu_path_counts_no_launch():
    _, (ht, hit) = _mxu_tables("float32")
    tmxu.reset_launch_counts()
    tmxu.filter_sum_mxu(torch.zeros((3, TB, N, FPAD)),
                        torch.zeros((3, TB, N, FPAD)), ht, hit)
    tmxu.filter_sum_mxu_t(torch.zeros((3, TB * TT, FPAD)),
                          torch.zeros((3, TB * TT, FPAD)), ht, hit, TB)
    assert tmxu.launch_counts() == {"filter_sum_mxu": 0,
                                    "filter_sum_mxu_t": 0}


# ---------------------------------------------------------------------------
# Tables and operators
# ---------------------------------------------------------------------------

GEO = dict(N=32, num_nodes=3, angles_total=30)


def _geos():
    t = tcfg.GeometryConfig(**GEO)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _both_tables(dtype_name):
    gt, gj = _geos()
    a, v, _ = tradon.node_angles(gt)
    tt = tfft.precompute_merged_mxu(
        gt, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        getattr(torch, dtype_name))
    tj = jfft.precompute_merged_mxu(gj, jnp.asarray(a, jnp.float32),
                                    jnp.asarray(v), jnp.dtype(dtype_name))
    return gt, gj, tt, tj


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mxu_tables_match_jax(dtype_name):
    _, _, tt, tj = _both_tables(dtype_name)
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
        elif k in ("onehot", "posfull", "invposfull"):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=TABLE_RTOL * max(np.abs(want).max(), 1e-30), err_msg=k)


def _inputs(gt, seed=0):
    rng = np.random.default_rng(seed)
    P, n = gt.num_nodes, gt.N
    m = max(gt.angles_per_node())
    return (rng.standard_normal((P, n, n)).astype(np.float32),
            rng.standard_normal((P, m, gt.n_det)).astype(np.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mxu_operators_match_jax(dtype_name):
    gt, gj, tt, tj = _both_tables(dtype_name)
    x, y = _inputs(gt)
    rtol = OP_RTOL[dtype_name]
    _close(tfft.project_nodes_mxu(gt, torch.as_tensor(x), tt),
           jfft.project_nodes_mxu(gj, jnp.asarray(x), tj), rtol)
    _close(tfft.backproject_nodes_mxu(gt, torch.as_tensor(y), tt),
           jfft.backproject_nodes_mxu(gj, jnp.asarray(y), tj), rtol)


def test_mxu_adjoint_identity_and_equals_pallas():
    """<Ax, y> = <x, A^T y> on the port's own f32 tables, and the operator
    is the one ``fft_pallas`` applies."""
    gt, _, tt, _ = _both_tables("float32")
    a, v, _ = tradon.node_angles(gt)
    tm = tfft.precompute_merged_nodes(
        gt, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v))
    x, y = (torch.as_tensor(u) for u in _inputs(gt, seed=1))
    Ax = tfft.project_nodes_mxu(gt, x, tt)
    Aty = tfft.backproject_nodes_mxu(gt, y, tt)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                 * torch.linalg.norm(y.double()))
    assert rel <= 1e-5, rel
    _close(Ax, tfft.project_nodes_merged(gt, x, tm).numpy(), 1e-5)
    _close(Aty, tfft.backproject_nodes_merged(gt, y, tm).numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Problem build, bundles, the loop, and what is rejected
# ---------------------------------------------------------------------------


def _cfg_jax():
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(**GEO),
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
def mxu_build():
    """A JAX fft_mxu problem and the port's own build of it, given JAX's
    noise draw and power-method start."""
    cfg_j = _cfg_jax()
    pj = jloader.build_problem(cfg_j, mode="fft_mxu")
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode="fft_mxu",
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    return cfg_j, pj, pt


@pytest.fixture(scope="module")
def mxu_bundle(mxu_build, tmp_path_factory):
    """The JAX problem of ``mxu_build`` through a ``save_problem`` bundle,
    loaded by the port (its tables included)."""
    _, pj, _ = mxu_build
    path = str(tmp_path_factory.mktemp("bundle") / "mxu.npz")
    jser.save_problem(pj, path)
    return tser.load_problem(path, "cpu")


def test_mxu_build_matches_jax(mxu_build):
    _, pj, pt = mxu_build
    assert pt.mode == pj.mode == "fft_mxu"
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


def test_mxu_bundle_loads(mxu_build, mxu_bundle):
    """A JAX ``save_problem`` bundle of mode fft_mxu loads, and its forward
    is the JAX problem's."""
    _, pj, _ = mxu_build
    tp = mxu_bundle
    assert tp.mode == "fft_mxu" and tp.fft_tables["posfull"].dtype == torch.int32
    x = np.random.default_rng(3).standard_normal(
        (pj.num_nodes, pj.n)).astype(np.float32)
    _close(tp.forward(torch.as_tensor(x)), pj.forward(jnp.asarray(x)),
           OP_RTOL["float32"])


RECOMMENDED = dict(relax_alpha=1.8, use_pallas=True,
                   node=dict(algorithm="fcv", max_inner=15, check_every=15))
RTOL, ATOL, FCV_HIST_RTOL = 1e-4, 1e-5, 1e-3  # as in test_torch_admm.py


def _over(admm_cfg, over):
    over = dict(over)
    node = dataclasses.replace(admm_cfg.node, **over.pop("node", {}))
    return dataclasses.replace(admm_cfg, node=node, **over)


@pytest.fixture(scope="module")
def mxu_jax_run(mxu_build):
    cfg_j, pj, _ = mxu_build
    return jadmm.run_admm(pj, _over(cfg_j.admm, RECOMMENDED))


@pytest.mark.parametrize("source", ["bundle", "port_build"])
def test_mxu_recommended_three_outers_match_jax(mxu_build, mxu_bundle,
                                                mxu_jax_run, source):
    """Three outers of the recommended preset with JAX's Lanczos start, on
    the loaded JAX bundle (data and tables) and on the port's own build (its
    tables and data, from JAX's noise draw and power-method start)."""
    cfg_j, _, pt = mxu_build
    res_j = mxu_jax_run
    tp = mxu_bundle if source == "bundle" else pt
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


def test_mxu_rejects_fan_beam():
    geo = tcfg.GeometryConfig(N=24, num_nodes=2, angles_total=64,
                              fan_beam=True)
    cfg = tcfg.ProblemConfig(geometry=geo, phantom="shepp")
    with pytest.raises(NotImplementedError, match="parallel beam only"):
        tloader.build_problem(cfg, "cpu", mode="fft_mxu")
    x = torch.zeros((2, 24, 24))
    for fn in (tfft.project_nodes_mxu, tfft.backproject_nodes_mxu):
        with pytest.raises(NotImplementedError, match="parallel beam only"):
            fn(geo, x, {})
