"""The ``fft_shear`` projector mode of the PyTorch port against the JAX
package, on the CPU, on numpy-seeded inputs: the spectral shear kernels
K7/K8 (their plain versions against the JAX Pallas kernels in interpret
mode, with the plane of every angle block from the tables, mixed per node,
and all on plane 0), the "shear" layout of ``precompute_shear``, the
operator pair and the adjoint identity, the problem build, a loaded JAX
bundle, and three outers of the recommended preset on that bundle and on
the port's own build (parallel beam, N = 32 with 3 nodes, 8-row blocks:
NB = 4).

Tolerances: K7 to 1e-5 of the output's max with f32 and with bf16 tables
(both sides round the spectra to bf16 at the same point, the products are
exact and only the order of the f32 sums differs); K8 to 1e-5 with f32
tables and 2e-3 with bf16 tables (its S is rounded to bf16 from an f32
value whose last bit may differ, so a rounding can land on the other side);
tables to 1e-5 of their max in f32 and to one bf16 ulp in bf16; operators
to 1e-4 of the output's max with f32 tables and 2e-3 with bf16 tables; the
adjoint identity to 1e-5 relative; the build and the ADMM histories as in
``test_torch_fft_pallas.py``. Of the histories, the primal residuals come
closest to their 1e-3 limit (8e-4 on the port's own build): each is the
norm of x_i - z_ij, about 3e-5 of the norm of x_i after three outers, so
states that agree to a few 1e-7 of their norm (f32 sums in another order,
f32 tables that differ in the last bit) leave it ~1e-3 apart. On the CPU
every kernel wrapper runs its plain version; the CUDA kernels are held to
those on the card."""

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
from dip_admm_tpu.ops.pallas import shear_sum as jss
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import shear_sum as tss

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K7_RTOL = 1e-5
K8_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
TABLE_RTOL = 1e-5
GEO = dict(N=32, num_nodes=3, angles_total=30)
NB_ROWS = 8  # row block: NB = 4


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


def _geos():
    t = tcfg.GeometryConfig(**GEO)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _angles(gt):
    a, v, _ = tradon.node_angles(gt)
    return (torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
            jnp.asarray(a, jnp.float32), jnp.asarray(v))


# ---------------------------------------------------------------------------
# K7/K8
# ---------------------------------------------------------------------------


def _plane_tables(planes, PT, TB):
    """(plane, pfirst, pvisited) of each node. "mixed": node 0 reads plane 0
    then plane 1, node 1 only plane 1, node 2 only plane 0 (monotone per
    node, as the JAX kernel needs); "single": every block on plane 0."""
    if planes == "single":
        plane = np.zeros((PT, TB), np.int32)
    else:
        assert PT == 3 and TB == 2
        plane = np.array([[0, 1], [1, 1], [0, 0]], np.int32)
    pfirst = np.zeros_like(plane)
    pfirst[:, 0] = 1
    pfirst[:, 1:] = plane[:, 1:] != plane[:, :-1]
    pvisited = np.stack([(plane == k).any(axis=1) for k in (0, 1)], axis=1)
    return plane, pfirst, pvisited


def _kernel_tables(dtype_name, planes):
    """The JAX package's shear tables of GEO (8-row blocks) with the plane
    tables of ``planes``: (JAX arrays, torch tensors, pvisited)."""
    gt, gj = _geos()
    _, _, aj, vj = _angles(gt)
    tj = jfft.precompute_shear(gj, aj, vj, jnp.dtype(dtype_name), nb=NB_ROWS)
    PT, TB = tj["plane"].shape
    plane, pfirst, vis = _plane_tables(planes, PT, TB)
    j = dict(Wt=tj["Wt"], SEre=tj["SEre"], SEim=tj["SEim"],
             Phire=tj["shared"]["Phire"], Phiim=tj["shared"]["Phiim"],
             plane=jnp.asarray(plane), pfirst=jnp.asarray(pfirst))
    t = {k: _to_torch(v) for k, v in j.items()}
    return j, t, vis


# (images, table sets): one table set per image, and three images per set
# (JAX: jax.vmap over the images, whose rule folds them into the node axis).
BATCHES = [(3, 3), (9, 3)]


def _jax_batched(fn, x, PB, PT):
    if PB == PT:
        return fn(*x)
    xs = [a.reshape((PB // PT, PT) + a.shape[1:]) for a in x]
    out = jax.vmap(fn)(*xs)
    return [np.asarray(o).reshape((PB,) + o.shape[2:]) for o in out]


@pytest.mark.parametrize("planes", ["mixed", "single"])
@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_sum_planes_matches_jax(dtype_name, batch, planes):
    PB, PT = batch
    j, t, _ = _kernel_tables(dtype_name, planes)
    _, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    r = np.random.default_rng(0).standard_normal(
        (2, PB, 2, NB * nb, F)).astype(np.float32)
    keys = ("Wt", "SEre", "SEim", "Phire", "Phiim", "plane")
    want = _jax_batched(
        lambda a, b: jss.shear_sum_planes(a, b, *(j[k] for k in keys)),
        [jnp.asarray(r[0]), jnp.asarray(r[1])], PB, PT)
    got = tss.shear_sum_planes(torch.as_tensor(r[0]), torch.as_tensor(r[1]),
                               *(t[k] for k in keys))
    for g, w in zip(got, want):
        assert g.shape == (PB, Tp, F)
        _close(g, w, K7_RTOL)


@pytest.mark.parametrize("planes", ["mixed", "single"])
@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB9PT3"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_sum_planes_t_matches_jax(dtype_name, batch, planes):
    PB, PT = batch
    j, t, vis = _kernel_tables(dtype_name, planes)
    _, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    g = np.random.default_rng(1).standard_normal(
        (2, PB, Tp, F)).astype(np.float32)
    keys = ("Wt", "SEre", "SEim", "Phire", "Phiim", "plane")
    want = _jax_batched(
        lambda a, b: jss.shear_sum_planes_t(a, b, *(j[k] for k in keys),
                                            j["pfirst"]),
        [jnp.asarray(g[0]), jnp.asarray(g[1])], PB, PT)
    got = tss.shear_sum_planes_t(torch.as_tensor(g[0]), torch.as_tensor(g[1]),
                                 *(t[k] for k in keys))
    # The JAX kernel leaves a plane that no block reads undefined (its chain
    # masks it by pvisited); the port writes zeros there.
    seen = np.tile(vis, (PB // PT, 1))[:, :, None, None]
    for a, w in zip(got, want):
        assert a.shape == (PB, 2, NB * nb, F)
        _close(a, np.where(seen, np.asarray(w), 0.0), K8_RTOL[dtype_name])
        unread = np.broadcast_to(~seen, a.shape)
        assert unread.any()
        assert (a.numpy()[unread] == 0).all()


def test_shear_pair_is_a_transpose():
    """<K7 r, g> = <r, K8 g> with three images per table set, f32 tables."""
    _, t, _ = _kernel_tables("float32", "mixed")
    _, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    keys = ("Wt", "SEre", "SEim", "Phire", "Phiim", "plane")
    gen = torch.Generator().manual_seed(5)
    r = torch.randn((2, 9, 2, NB * nb, F), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 9, Tp, F), generator=gen, dtype=torch.float64)
    Kr = tss.shear_sum_planes(r[0].float(), r[1].float(),
                              *(t[k] for k in keys))
    Ktg = tss.shear_sum_planes_t(g[0].float(), g[1].float(),
                                 *(t[k] for k in keys))
    lhs = sum(float((a.double() * b).sum()) for a, b in zip(Kr, g))
    rhs = sum(float((a * b.double()).sum()) for a, b in zip(r, Ktg))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_shear_cpu_path_counts_no_launch():
    _, t, _ = _kernel_tables("float32", "single")
    _, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    keys = ("Wt", "SEre", "SEim", "Phire", "Phiim", "plane")
    tss.reset_launch_counts()
    tss.shear_sum_planes(torch.zeros((3, 2, NB * nb, F)),
                         torch.zeros((3, 2, NB * nb, F)),
                         *(t[k] for k in keys))
    tss.shear_sum_planes_t(torch.zeros((3, Tp, F)), torch.zeros((3, Tp, F)),
                           *(t[k] for k in keys))
    assert tss.launch_counts()["shear_sum_planes"] == 0
    assert tss.launch_counts()["shear_sum_planes_t"] == 0


# ---------------------------------------------------------------------------
# Tables and operators
# ---------------------------------------------------------------------------


def _both_tables(dtype_name):
    gt, gj = _geos()
    at, vt, aj, vj = _angles(gt)
    tt = tfft.precompute_shear(gt, at, vt, getattr(torch, dtype_name),
                               nb=NB_ROWS, layout="shear")
    tj = jfft.precompute_shear(gj, aj, vj, jnp.dtype(dtype_name), nb=NB_ROWS)
    return gt, gj, tt, tj


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_tables_match_jax(dtype_name):
    """The "shear" layout: integer tables equal, the others to 1e-5 of
    their max (f32) or one bf16 ulp; no skew-only table."""
    _, _, tt, tj = _both_tables(dtype_name)
    assert "WtT" not in tt and "Dre" not in tt["shared"]
    for k in ("plane", "pfirst", "posfull", "invposfull", "pvisited"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]))
    flat = {**{k: v for k, v in tt.items() if k != "shared"}, **tt["shared"]}
    jflat = {**{k: v for k, v in tj.items() if k != "shared"}, **tj["shared"]}
    for k in ("Wt", "SEre", "SEim", "Wd", "TEre", "TEim", "Ere", "Eim",
              "Phire", "Phiim", "PhiDre", "PhiDim"):
        got, want = flat[k], np.asarray(jflat[k])
        assert tuple(got.shape) == want.shape, k
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16, k
            g, w = got.float().numpy(), want.astype(np.float32)
            mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
            ulp = np.exp2(np.floor(np.log2(mag)) - 7)
            assert (np.abs(g - w) <= ulp * (1 + 1e-6)).all(), k
        else:
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=TABLE_RTOL * max(np.abs(want).max(), 1e-30), err_msg=k)


def test_layouts_share_their_tables():
    """Both layouts hold the same geometry: the common tables bit for bit,
    and the taps as the same values in two orders."""
    gt, _ = _geos()
    at, vt, _, _ = _angles(gt)
    skew = tfft.precompute_shear(gt, at, vt, nb=NB_ROWS)
    shear = tfft.precompute_shear(gt, at, vt, nb=NB_ROWS, layout="shear")
    assert set(skew) - set(shear) == {"WtT"}
    assert set(shear) - set(skew) == {"Wt", "Ere", "Eim"}
    assert torch.equal(skew["WtT"], shear["Wt"].transpose(2, 3))
    for k in ("SEre", "SEim", "Wd", "TEre", "TEim", "posfull", "plane"):
        assert torch.equal(skew[k], shear[k]), k
    for k in ("PhiDre", "PhiDim"):
        assert torch.equal(skew["shared"][k], shear["shared"][k]), k
    with pytest.raises(ValueError):
        tfft.precompute_shear(gt, at, vt, layout="spectral")


def _inputs(gt, seed=0):
    rng = np.random.default_rng(seed)
    P, N = gt.num_nodes, gt.N
    m = max(gt.angles_per_node())
    return (rng.standard_normal((P, N, N)).astype(np.float32),
            rng.standard_normal((P, m, gt.n_det)).astype(np.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_operators_match_jax(dtype_name):
    gt, gj, tt, tj = _both_tables(dtype_name)
    x, y = _inputs(gt)
    rtol = OP_RTOL[dtype_name]
    _close(tfft.project_nodes_shear(gt, torch.as_tensor(x), tt),
           jfft.project_nodes_shear(gj, jnp.asarray(x), tj), rtol)
    _close(tfft.backproject_nodes_shear(gt, torch.as_tensor(y), tt),
           jfft.backproject_nodes_shear(gj, jnp.asarray(y), tj), rtol)


def test_shear_adjoint_identity_and_equals_skew():
    """<Ax, y> = <x, A^T y> on the port's own f32 tables, and the operator
    is the one ``fft_skew`` applies."""
    gt, _, tt, _ = _both_tables("float32")
    at, vt, _, _ = _angles(gt)
    ts = tfft.precompute_shear(gt, at, vt, nb=NB_ROWS)
    x, y = (torch.as_tensor(u) for u in _inputs(gt, seed=1))
    Ax = tfft.project_nodes_shear(gt, x, tt)
    Aty = tfft.backproject_nodes_shear(gt, y, tt)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                 * torch.linalg.norm(y.double()))
    assert rel <= 1e-5, rel
    _close(Ax, tfft.project_nodes_skew(gt, x, ts).numpy(), 1e-5)
    _close(Aty, tfft.backproject_nodes_skew(gt, y, ts).numpy(), 1e-5)


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
def shear_build():
    """A JAX fft_shear problem and the port's own build of it, given JAX's
    noise draw and power-method start."""
    cfg_j = _cfg_jax()
    pj = jloader.build_problem(cfg_j, mode="fft_shear")
    P, n = cfg_j.geometry.num_nodes, cfg_j.geometry.n
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                    dtype=jnp.float32))
    noise = np.array(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode="fft_shear",
                               noise=torch.as_tensor(noise),
                               opnorm_v0=torch.as_tensor(v0))
    return cfg_j, pj, pt


def test_shear_build_matches_jax(shear_build):
    _, pj, pt = shear_build
    assert pt.mode == pj.mode == "fft_shear"
    assert "WtT" not in pt.fft_tables
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


@pytest.fixture(scope="module")
def shear_bundle(shear_build, tmp_path_factory):
    """The JAX problem of ``shear_build`` through a ``save_problem`` bundle,
    loaded by the port (its tables included)."""
    _, pj, _ = shear_build
    path = str(tmp_path_factory.mktemp("bundle") / "shear.npz")
    jser.save_problem(pj, path)
    return tser.load_problem(path, "cpu")


def test_shear_bundle_loads(shear_build, shear_bundle):
    """A JAX ``save_problem`` bundle of mode fft_shear loads with its
    t-major taps, and its forward is the JAX problem's."""
    _, pj, _ = shear_build
    tp = shear_bundle
    assert tp.mode == "fft_shear"
    assert "Wt" in tp.fft_tables and "WtT" not in tp.fft_tables
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
def shear_jax_run(shear_build):
    cfg_j, pj, _ = shear_build
    return jadmm.run_admm(pj, _over(cfg_j.admm, RECOMMENDED))


@pytest.mark.parametrize("source", ["bundle", "port_build"])
def test_shear_recommended_three_outers_match_jax(shear_build, shear_bundle,
                                                  shear_jax_run, source):
    """Three outers of the recommended preset with JAX's Lanczos start, on
    the loaded JAX bundle (data and tables) and on the port's own build (its
    tables and data, from JAX's noise draw and power-method start)."""
    cfg_j, _, pt = shear_build
    res_j = shear_jax_run
    tp = shear_bundle if source == "bundle" else pt
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


def test_shear_rejects_fan_beam():
    geo = tcfg.GeometryConfig(N=24, num_nodes=2, angles_total=64,
                              fan_beam=True)
    cfg = tcfg.ProblemConfig(geometry=geo, phantom="shepp")
    with pytest.raises(NotImplementedError, match="parallel beam only"):
        tloader.build_problem(cfg, "cpu", mode="fft_shear")
    x = torch.zeros((2, 24, 24))
    for fn in (tfft.project_nodes_shear, tfft.backproject_nodes_shear):
        with pytest.raises(NotImplementedError, match="parallel beam only"):
            fn(geo, x, {})
