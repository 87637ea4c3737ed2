"""The four ``fft_skew`` kernels of the PyTorch port, and K9/K10 (the shear
stage on gathered slot spectra), against the JAX package's Pallas kernels
(interpret mode on the CPU), on the same tables and the same seeded
inputs, with f32 tables (relative 1e-5) and bf16
tables (relative 2e-3: the sums run in another order, and a bf16 rounding
of an intermediate can land on the other side). On the CPU every port
wrapper runs its plain PyTorch version; the CUDA kernels are held against
the same plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import shear_sum as jss
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import shear_sum as tss

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = {"float32": 1e-5, "bfloat16": 2e-3}


def _to_torch(a):
    a = np.array(a)  # a writable copy
    if a.dtype == ml_dtypes.bfloat16:
        return torch.as_tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def _tables_to_torch(t):
    out = {k: _to_torch(v) for k, v in t.items() if k != "shared"}
    out["shared"] = {k: _to_torch(v) for k, v in t["shared"].items()}
    for k in ("plane", "posfull", "invposfull", "pfirst"):
        out[k] = out[k].to(torch.int32)
    return out


def _setup(dtype_name, N=32, P=3, angles_total=30, nb=16):
    geo_t = tcfg.GeometryConfig(N=N, num_nodes=P, angles_total=angles_total)
    geo_j = jcfg.GeometryConfig(**dataclasses.asdict(geo_t))
    a, v, _ = tradon.node_angles(geo_t)
    tj = jfft.precompute_shear(geo_j, jnp.asarray(a, jnp.float32),
                               jnp.asarray(v), jnp.dtype(dtype_name), nb=nb)
    return geo_t, geo_j, tj, _tables_to_torch(tj)


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_skew_sum_planes_matches_jax(dtype_name):
    _, _, tj, tt = _setup(dtype_name)
    P, NB, D2, Tp, nb = tt["WtT"].shape
    N = NB * nb
    rows2 = np.random.default_rng(0).standard_normal((P, 2, N, N)).astype(
        np.float32)
    sh, jsh = tt["shared"], tj["shared"]
    want = jss.skew_sum_planes(jnp.asarray(rows2), tj["WtT"], tj["SEre"],
                               tj["SEim"], jsh["Dre"], jsh["Dim"], tj["plane"])
    got = tss.skew_sum_planes(torch.as_tensor(rows2), tt["WtT"], tt["SEre"],
                              tt["SEim"], sh["Dre"], sh["Dim"], tt["plane"])
    for g, w in zip(got, want):
        _close(g, w, RTOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_skew_sum_planes_t_matches_jax(dtype_name):
    _, _, tj, tt = _setup(dtype_name)
    P, NB, D2, Tp, nb = tt["WtT"].shape
    F = tt["SEre"].shape[-1]
    rng = np.random.default_rng(1)
    gre = rng.standard_normal((P, Tp, F)).astype(np.float32)
    gim = rng.standard_normal((P, Tp, F)).astype(np.float32)
    sh, jsh = tt["shared"], tj["shared"]
    want = jss.skew_sum_planes_t(
        jnp.asarray(gre), jnp.asarray(gim), tj["WtT"], tj["SEre"], tj["SEim"],
        jsh["DreT"], jsh["DimT"], tj["plane"], tj["pfirst"])
    vis = np.asarray(tj["pvisited"])[:, :, None, None] > 0
    want = np.where(vis, np.asarray(want), 0.0)
    got = tss.skew_sum_planes_t(
        torch.as_tensor(gre), torch.as_tensor(gim), tt["WtT"], tt["SEre"],
        tt["SEim"], sh["DreT"], sh["DimT"], tt["plane"])
    _close(got, want, RTOL[dtype_name])
    # planes no angle block reads come out zero, not uninitialized
    assert (got.numpy()[~np.broadcast_to(vis, got.shape)] == 0).all()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_eval_shear_matches_jax(dtype_name):
    _, _, tj, tt = _setup(dtype_name)
    P, DB, Tp, D2p, db = tt["Wd"].shape
    F = tt["TEre"].shape[-1]
    rng = np.random.default_rng(2)
    gre = rng.standard_normal((P, Tp, F)).astype(np.float32)
    gim = rng.standard_normal((P, Tp, F)).astype(np.float32)
    sh, jsh = tt["shared"], tj["shared"]
    want = jss.eval_shear(jnp.asarray(gre), jnp.asarray(gim), tj["Wd"],
                          tj["TEre"], tj["TEim"], jsh["PhiDre"], jsh["PhiDim"])
    got = tss.eval_shear(torch.as_tensor(gre), torch.as_tensor(gim),
                         tt["Wd"], tt["TEre"], tt["TEim"], sh["PhiDre"],
                         sh["PhiDim"])
    _close(got, want, RTOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_eval_shear_t_matches_jax(dtype_name):
    _, _, tj, tt = _setup(dtype_name)
    P, DB, Tp, D2p, db = tt["Wd"].shape
    ob = np.random.default_rng(3).standard_normal((P, Tp, DB * db)).astype(
        np.float32)
    sh, jsh = tt["shared"], tj["shared"]
    want = jss.eval_shear_t(jnp.asarray(ob), tj["Wd"], tj["TEre"],
                            tj["TEim"], jsh["PhiDre"], jsh["PhiDim"])
    got = tss.eval_shear_t(torch.as_tensor(ob), tt["Wd"], tt["TEre"],
                           tt["TEim"], sh["PhiDre"], sh["PhiDim"])
    for g, w in zip(got, want):
        _close(g, w, RTOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_project_backproject_match_jax(dtype_name):
    geo_t, geo_j, tj, tt = _setup(dtype_name)
    P, N = geo_t.num_nodes, geo_t.N
    T = max(geo_t.angles_per_node())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((P, N, N)).astype(np.float32)
    y = rng.standard_normal((P, T, geo_t.n_det)).astype(np.float32)
    _close(tfft.project_nodes_skew(geo_t, torch.as_tensor(x), tt),
           jfft.project_nodes_skew(geo_j, jnp.asarray(x), tj),
           RTOL[dtype_name])
    _close(tfft.backproject_nodes_skew(geo_t, torch.as_tensor(y), tt),
           jfft.backproject_nodes_skew(geo_j, jnp.asarray(y), tj),
           RTOL[dtype_name])


@pytest.mark.parametrize("N,angles_total", [(32, 30), (40, 45)])
def test_port_adjoint_identity(N, angles_total):
    """<Ax, y> = <x, A^T y> on the port's own tables (f32), with two 16-row
    blocks (N = 32) and with five 8-row blocks (N = 40)."""
    geo = tcfg.GeometryConfig(N=N, num_nodes=3, angles_total=angles_total)
    a, v, _ = tradon.node_angles(geo)
    t = tfft.precompute_shear(geo, torch.as_tensor(a, dtype=torch.float32),
                              torch.as_tensor(v), nb=16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, N, N), generator=gen, dtype=torch.float64).float()
    y = torch.randn((3, a.shape[1], N), generator=gen,
                    dtype=torch.float64).float()
    Ax = tfft.project_nodes_skew(geo, x, t)
    Aty = tfft.backproject_nodes_skew(geo, y, t)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax) * torch.linalg.norm(y))
    assert rel <= 1e-5, rel


# ---------------------------------------------------------------------------
# K9/K10: the shear stage on slot spectra gathered one-hot per angle block
# (tests/test_fft_shear.py:80-105 in the JAX package's tests)


def _shear_setup(dtype_name):
    _, _, tj, tt = _setup(dtype_name, N=16, P=3, angles_total=24)
    P, NB, Tp, D2, nb = tt["Wt"].shape
    TB, F = tt["onehot"].shape[1], tt["SEre"].shape[-1]
    rng = np.random.default_rng(5)
    r = [rng.standard_normal((P, TB, NB * nb, F)).astype(np.float32)
         for _ in range(2)]
    g = [rng.standard_normal((P, Tp, F)).astype(np.float32) for _ in range(2)]
    keys = ("Wt", "SEre", "SEim")
    jtabs = (*(tj[k] for k in keys), tj["shared"]["Phire"],
             tj["shared"]["Phiim"])
    ttabs = (*(tt[k] for k in keys), tt["shared"]["Phire"],
             tt["shared"]["Phiim"])
    return tj, tt, r, g, jtabs, ttabs


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_sum_matches_jax(dtype_name):
    """K9 against JAX's interpret-mode ``shear_sum`` and, with f32 tables,
    its plain ``shear_sum_reference`` (which does not round the spectra to
    the table type, as the kernel does with bf16 tables)."""
    _, _, r, _, jtabs, ttabs = _shear_setup(dtype_name)
    got = tss.shear_sum(*(torch.as_tensor(v) for v in r), *ttabs)
    want = jss.shear_sum(*(jnp.asarray(v) for v in r), *jtabs)
    for gt, w in zip(got, want):
        _close(gt, w, RTOL[dtype_name])
    if dtype_name == "float32":
        ref = jss.shear_sum_reference(*(jnp.asarray(v) for v in r), *jtabs)
        for gt, w in zip(got, ref):
            _close(gt, w, RTOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_sum_t_matches_jax(dtype_name):
    """K10 against JAX's interpret-mode ``shear_sum_t`` and, with f32
    tables, the ``jax.linear_transpose`` of ``shear_sum_reference``."""
    tj, tt, r, g, jtabs, ttabs = _shear_setup(dtype_name)
    TB = tt["onehot"].shape[1]
    got = tss.shear_sum_t(*(torch.as_tensor(v) for v in g), *ttabs, TB)
    assert got[0].shape == r[0].shape
    want = jss.shear_sum_t(*(jnp.asarray(v) for v in g), *jtabs, tj["onehot"])
    for gt, w in zip(got, want):
        _close(gt, w, RTOL[dtype_name])
    if dtype_name == "float32":
        ref = jax.linear_transpose(
            lambda a, b: jss.shear_sum_reference(a, b, *jtabs),
            *(jnp.asarray(v) for v in r))(tuple(jnp.asarray(v) for v in g))
        for gt, w in zip(got, ref):
            _close(gt, w, RTOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_shear_sum_pair_is_k7_k8_on_gathered_spectra(dtype_name):
    """K9 on the planes gathered one-hot by ``plane`` is K7, bit for bit;
    K10 summed back over the one-hot is K8 (1e-6 of the output's max: the
    angle blocks of a plane added after the tap sums instead of inside)."""
    _, tt, _, g, _, ttabs = _shear_setup(dtype_name)
    P, NB, Tp, D2, nb = tt["Wt"].shape
    F = tt["SEre"].shape[-1]
    plane = tt["plane"]
    rng = np.random.default_rng(6)
    r2 = [torch.as_tensor(rng.standard_normal((P, 2, NB * nb, F)).astype(
        np.float32)) for _ in range(2)]
    pidx = torch.arange(P)[:, None]
    gathered = [v[pidx, plane.long()] for v in r2]
    for a, b in zip(tss.shear_sum(*gathered, *ttabs),
                    tss.shear_sum_planes(*r2, *ttabs, plane)):
        assert torch.equal(a, b)
    gt = [torch.as_tensor(v) for v in g]
    onehot = torch.nn.functional.one_hot(plane.long(), 2).float()
    for a, b in zip(tss.shear_sum_t(*gt, *ttabs, plane.shape[1]),
                    tss.shear_sum_planes_t(*gt, *ttabs, plane)):
        _close(torch.einsum("ptnf,pto->ponf", a, onehot), b.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# The algebra of K1's tensor-core kernel (bf16 tables), mirrored in numpy
# and held to the JAX package's kernel in interpret mode.


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _k1_inputs(PB, PT, NB, nb, TB, tt, seed):
    """Tables of PT sets built as the loader builds them (two adjacent taps
    per (row block, slot, row), phases E of unit modulus, a DFT-back D),
    bf16, and the rows of PB images [PB, 2, N, N]."""
    rng = np.random.default_rng(seed)
    N, Tp = NB * nb, TB * tt
    D2 = -(-(nb + 2) // 16) * 16
    WZ = -(-(N + D2 - 1) // 128) * 128
    F = N // 2 + 1
    WtT = np.zeros((PT, NB, D2, Tp, nb), np.float32)
    d0 = rng.integers(0, D2 - 1, (PT, NB, Tp, nb))
    fr = rng.uniform(0.0, 1.0, (PT, NB, Tp, nb)).astype(np.float32)
    i = np.indices(d0.shape)
    WtT[i[0], i[1], d0, i[2], i[3]] = 1.0 - fr
    WtT[i[0], i[1], d0 + 1, i[2], i[3]] += fr
    ph = rng.uniform(0.0, 2.0 * np.pi, (PT, NB, Tp, F))
    ang = 2.0 * np.pi / (2 * N) * np.outer(np.arange(WZ) - (D2 - 1),
                                           np.arange(F))
    return dict(
        rows2=rng.standard_normal((PB, 2, N, N)).astype(np.float32),
        WtT=_bf16(WtT), SEre=np.cos(ph).astype(np.float32),
        SEim=np.sin(ph).astype(np.float32), Dre=_bf16(np.cos(ang)),
        Dim=_bf16(-np.sin(ang)),
        plane=rng.integers(0, 2, (PT, TB)).astype(np.int32))


def _k1_tensor_core_mirror(rows2, WtT, SEre, SEim, Dre, Dim, plane):
    """K1 as its bf16 tensor-core kernel computes it. Per (image p, angle
    block tb, row block b): the row window rounded to bf16 once, in its
    Hankel view H[v, (d, n)] = x[n, v - (D2-1) + d] (zero outside the row),
    times the taps as a [(d, n), t] matrix, summed in f32; z rounded to
    bf16 over the columns v < WS + D2 - 1 that can be nonzero; then each
    row block's term E_b * (z_b @ D) formed whole and added to the running
    f32 sum in ascending b."""
    PB, _, N, WS = rows2.shape
    PT, NB, D2, Tp, nb = WtT.shape
    TB = plane.shape[1]
    tt = Tp // TB
    F = Dre.shape[1]
    vmax = WS + D2 - 1
    W = WtT.astype(np.float32)
    D = Dre.astype(np.float32)[:vmax], Dim.astype(np.float32)[:vmax]
    gre = np.zeros((PB, Tp, F), np.float32)
    gim = np.zeros((PB, Tp, F), np.float32)
    for p in range(PB):
        pt = p % PT
        for tb in range(TB):
            ts = slice(tb * tt, (tb + 1) * tt)
            for b in range(NB):
                x = _bf16(rows2[p, plane[pt, tb], b * nb:(b + 1) * nb])
                xp = np.zeros((nb, WS + 2 * (D2 - 1)), np.float32)
                xp[:, D2 - 1:D2 - 1 + WS] = x.astype(np.float32)
                win = np.lib.stride_tricks.sliding_window_view(
                    xp.T, D2, axis=0)  # [v, n, d] = xp[n, v + d]
                H = win.transpose(0, 2, 1).reshape(vmax, D2 * nb)
                A = W[pt, b, :, ts, :].transpose(0, 2, 1).reshape(D2 * nb, tt)
                z = _bf16((H @ A).T).astype(np.float32)  # [tt, vmax]
                zr, zi = z @ D[0], z @ D[1]
                er, ei = SEre[pt, b, ts], SEim[pt, b, ts]
                gre[p, ts] += zr * er - zi * ei
                gim[p, ts] += zr * ei + zi * er
    return gre, gim


# (PB, PT, NB, nb, TB, tt): the fan's 8-slot blocks on one shared table
# set, the bench's 48-slot blocks, each on one row block (a row shard) and
# on two.
K1_SHAPES = [(3, 1, 2, 16, 3, 8), (2, 1, 1, 16, 2, 8), (2, 2, 2, 16, 2, 48),
             (2, 1, 1, 24, 2, 48)]


@pytest.mark.parametrize("shape", K1_SHAPES,
                         ids=["tt8-NB2-PT1", "tt8-NB1-PT1", "tt48-NB2-PT2",
                              "tt48-NB1-PT1"])
def test_k1_tensor_core_algebra_matches_jax(shape):
    """The mirror of K1's tensor-core kernel, and the port's plain version,
    against JAX's interpret-mode ``skew_sum_planes`` (relative 2e-3 with
    bf16 tables: z rounds to bf16 after sums taken in another order)."""
    k = _k1_inputs(*shape, seed=7)
    order = ("rows2", "WtT", "SEre", "SEim", "Dre", "Dim", "plane")
    want = jss.skew_sum_planes(*(jnp.asarray(k[n]) for n in order))
    mirror = _k1_tensor_core_mirror(*(k[n] for n in order))
    plain = tss.skew_sum_planes(*(_to_torch(k[n]) for n in order))
    for m, pl_, w in zip(mirror, plain, want):
        _close(m, w, RTOL["bfloat16"])
        _close(pl_, w, RTOL["bfloat16"])


def test_k1_row_block_terms_sum_as_the_row_shards_do():
    """Each row block's term is formed whole: K1's mirror on the two row
    blocks' tables summed, as the pixel axis sums two shards' outputs, is
    the mirror on both row blocks bit for bit."""
    k = _k1_inputs(2, 2, 2, 16, 2, 8, seed=8)
    order = ("rows2", "WtT", "SEre", "SEim", "Dre", "Dim", "plane")
    whole = _k1_tensor_core_mirror(*(k[n] for n in order))
    parts = []
    for s in range(2):
        loc = dict(k, rows2=np.ascontiguousarray(
            k["rows2"][:, :, 16 * s:16 * (s + 1)]))
        for n in ("WtT", "SEre", "SEim"):
            loc[n] = np.ascontiguousarray(k[n][:, s:s + 1])
        parts.append(_k1_tensor_core_mirror(*(loc[n] for n in order)))
    for i in range(2):
        np.testing.assert_array_equal(parts[0][i] + parts[1][i], whole[i])


# ---------------------------------------------------------------------------
# The algebra of K2's tensor-core kernels (bf16 tables), mirrored in numpy
# and held to the JAX package's kernel in interpret mode.


def _k2_inputs(PB, PT, NB, nb, TB, tt, seed):
    """K1's synthetic tables with the DFT-forward matrices D*T = D*.T, a
    plane sequence that is monotone per table set (the JAX kernel's
    accumulation needs consecutive revisits), its ``pfirst``/``pvisited``,
    and the slot spectra of PB images [PB, Tp, F]."""
    k = _k1_inputs(PB, PT, NB, nb, TB, tt, seed)
    rng = np.random.default_rng(seed + 100)
    F = k["SEre"].shape[-1]
    plane = np.sort(k["plane"], axis=1)
    pfirst = np.ones_like(plane)
    pfirst[:, 1:] = plane[:, 1:] != plane[:, :-1]
    pvisited = np.stack([(plane == s).any(axis=1) for s in (0, 1)], axis=1)
    return dict(
        gre=rng.standard_normal((PB, TB * tt, F)).astype(np.float32),
        gim=rng.standard_normal((PB, TB * tt, F)).astype(np.float32),
        WtT=k["WtT"], SEre=k["SEre"], SEim=k["SEim"],
        DreT=np.ascontiguousarray(k["Dre"].T),
        DimT=np.ascontiguousarray(k["Dim"].T), plane=plane, pfirst=pfirst,
        pvisited=pvisited)


def _k2_tensor_core_mirror(gre, gim, WtT, SEre, SEim, DreT, DimT, plane,
                           row_width):
    """K2 as its bf16 tensor-core kernels compute it. Per (image p, angle
    block tb, row block b): the phased cotangent Zr/Zi formed in f32 and
    rounded to bf16 once; zbar = Zr @ DreT + Zi @ DimT summed in f32 over
    the columns w < WS + D2 - 1 that a tap reads, rounded to bf16; then its
    Hankel view H[u, (d, t)] = zbar[t, u + D2-1-d] times the taps as a
    [(d, t), n] matrix (K in the order d, then t), summed in f32 and added
    to the plane's running sum in ascending tb. A plane no angle block
    reads stays zero."""
    PB, Tp, F = gre.shape
    PT, NB, D2, _, nb = WtT.shape
    TB = plane.shape[1]
    tt, WS = Tp // TB, row_width
    ZW = WS + D2 - 1
    W = WtT.astype(np.float32)
    DT = DreT.astype(np.float32)[:, :ZW], DimT.astype(np.float32)[:, :ZW]
    x2 = np.zeros((PB, 2, NB * nb, WS), np.float32)
    for p in range(PB):
        pt = p % PT
        for tb in range(TB):
            ts = slice(tb * tt, (tb + 1) * tt)
            g_r, g_i = gre[p, ts], gim[p, ts]
            for b in range(NB):
                er, ei = SEre[pt, b, ts], SEim[pt, b, ts]
                zr = _bf16(g_r * er + g_i * ei).astype(np.float32)
                zi = _bf16(g_i * er - g_r * ei).astype(np.float32)
                zbar = _bf16(zr @ DT[0] + zi @ DT[1]).astype(np.float32)
                win = np.lib.stride_tricks.sliding_window_view(
                    zbar.T, D2, axis=0)  # [u, t, e] = zbar[t, u + e]
                H = win[:, :, ::-1].transpose(0, 2, 1).reshape(WS, D2 * tt)
                A = W[pt, b, :, ts, :].reshape(D2 * tt, nb)
                x2[p, plane[pt, tb], b * nb:(b + 1) * nb] += (H @ A).T
    return x2


# K1's shapes, and K6's: row block 1 of 2 at the full row width.
K2_CASES = [(s, None) for s in K1_SHAPES] + [((2, 2, 2, 16, 2, 48), 1)]


@pytest.mark.parametrize("case", K2_CASES,
                         ids=["tt8-NB2-PT1", "tt8-NB1-PT1", "tt48-NB2-PT2",
                              "tt48-NB1-PT1", "k6-row-block-1-of-2"])
def test_k2_tensor_core_algebra_matches_jax(case):
    """The mirror of K2's tensor-core kernels, and the port's plain version,
    against JAX's interpret-mode ``skew_sum_planes_t`` (and, on one row
    block at the full row width, ``skew_sum_planes_t_rows``), relative 2e-3
    with bf16 tables; planes no angle block reads are zero."""
    shape, block = case
    k = _k2_inputs(*shape, seed=9)
    N = shape[2] * shape[3]
    if block is not None:
        for n in ("WtT", "SEre", "SEim"):
            k[n] = np.ascontiguousarray(k[n][:, block:block + 1])
    order = ("gre", "gim", "WtT", "SEre", "SEim", "DreT", "DimT", "plane")
    jargs = [jnp.asarray(k[n]) for n in order + ("pfirst",)]
    targs = [_to_torch(k[n]) for n in order]
    if block is None:
        want = jss.skew_sum_planes_t(*jargs)
        plain = tss.skew_sum_planes_t(*targs)
    else:
        mark = jnp.zeros((N,), jnp.float32)
        want = jss.skew_sum_planes_t_rows(*jargs, mark)
        plain = tss.skew_sum_planes_t_rows(*targs, N)
    vis = np.tile(k["pvisited"], (shape[0] // shape[1], 1))
    vis = np.broadcast_to(vis[:, :, None, None], want.shape)
    want = np.where(vis, np.asarray(want), 0.0)
    mirror = _k2_tensor_core_mirror(*(k[n] for n in order), row_width=N)
    assert mirror.shape == want.shape
    for got in (mirror, plain.numpy()):
        _close(got, want, RTOL["bfloat16"])
        assert (got[~vis] == 0).all()


def test_k2_row_blocks_concatenate_as_the_row_shards_do():
    """Each row block's output depends on its own tables alone: K2's mirror
    on each row block's tables at the full row width (K6, as a pixel shard
    runs it), concatenated along the rows, is the mirror on both row blocks
    bit for bit."""
    k = _k2_inputs(2, 2, 2, 16, 2, 8, seed=10)
    order = ("gre", "gim", "WtT", "SEre", "SEim", "DreT", "DimT", "plane")
    whole = _k2_tensor_core_mirror(*(k[n] for n in order), row_width=32)
    parts = []
    for s in range(2):
        loc = dict(k)
        for n in ("WtT", "SEre", "SEim"):
            loc[n] = np.ascontiguousarray(k[n][:, s:s + 1])
        parts.append(_k2_tensor_core_mirror(*(loc[n] for n in order),
                                            row_width=32))
    np.testing.assert_array_equal(np.concatenate(parts, axis=2), whole)


# ---------------------------------------------------------------------------
# The algebra of K3/K4's kernels with bf16 tables (the R stage and Abar/Bbar
# on the tensor cores, the Wd epilogue and pre-contraction as streams over
# the dense Wd), mirrored in numpy and held to the JAX package's kernels in
# interpret mode.


def _bf16f(a):
    return _bf16(a).astype(np.float32)


def _k34_inputs(PB, PT, DB, Tp, D2p, db, F, seed):
    """Eval-tail tables of PT sets built as the loader builds them (per
    (b, t, d) two adjacent taps at a detector offset that rises with d,
    times a row scale that is zero on some rows, as on padded slots; TE the
    irfft phases; PhiD the detector-offset phases), Wd in bf16, and the
    slot spectra and cotangent of PB images."""
    rng = np.random.default_rng(seed)
    Np = 2 * (F - 1)
    slope = rng.uniform(0.5, (D2p - 2) / db, (PT, DB, Tp, 1))
    pos = slope * np.arange(db) + rng.uniform(0.0, 1.0, (PT, DB, Tp, 1))
    k = np.floor(pos).astype(np.int64)
    fr = (pos - k).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (PT, DB, Tp, 1)).astype(np.float32)
    scale[rng.random((PT, DB, Tp, 1)) < 0.15] = 0.0
    Wd = np.zeros((PT, DB, Tp, D2p, db), np.float32)
    i = np.indices(k.shape)
    Wd[i[0], i[1], i[2], k, i[3]] = (1.0 - fr) * scale
    Wd[i[0], i[1], i[2], k + 1, i[3]] += fr * scale
    ang = (2.0 * np.pi / Np) * np.arange(F)
    cfac = np.full((F,), 2.0 / Np)
    cfac[0] = cfac[-1] = 1.0 / Np
    ph = ang * rng.integers(0, Np, (PT, DB, Tp, 1))
    ph_d = ang[None, :] * np.arange(D2p)[:, None]
    f32 = np.float32
    return dict(
        gre=rng.standard_normal((PB, Tp, F)).astype(f32),
        gim=rng.standard_normal((PB, Tp, F)).astype(f32),
        ob=rng.standard_normal((PB, Tp, DB * db)).astype(f32),
        Wd=_bf16(Wd), TEre=(cfac * np.cos(ph)).astype(f32),
        TEim=(cfac * np.sin(ph)).astype(f32), PhiDre=np.cos(ph_d).astype(f32),
        PhiDim=np.sin(ph_d).astype(f32))


def _k3_mirror(gre, gim, Wd, TEre, TEim, PhiDre, PhiDim):
    """K3 as its bf16 kernels compute it. R stage, per (image p, detector
    block b): A/B formed in f32 and rounded to bf16, PhiD rounded to bf16,
    R = A @ PhiDre^T - B @ PhiDim^T summed in f32 and kept in f32. Wd
    epilogue, per row (p, b, t): 16 groups of D2p / 16 consecutive z each
    sum R[z] * Wd[z, :] in ascending z; the partials are added in ascending
    group."""
    PB, Tp, F = gre.shape
    PT, DB, _, D2p, db = Wd.shape
    W = Wd.astype(np.float32)
    phr, phi = _bf16f(PhiDre), _bf16f(PhiDim)
    zpg = D2p // 16
    out = np.zeros((PB, Tp, DB * db), np.float32)
    for p in range(PB):
        pt = p % PT
        for b in range(DB):
            er, ei = TEre[pt, b], TEim[pt, b]
            A = _bf16f(gre[p] * er - gim[p] * ei)
            B = _bf16f(gre[p] * ei + gim[p] * er)
            R = A @ phr.T - B @ phi.T  # [Tp, D2p]
            parts = np.zeros((16, Tp, db), np.float32)
            for g in range(16):
                for z in range(g * zpg, (g + 1) * zpg):
                    parts[g] += R[:, z, None] * W[pt, b, :, z]
            s = parts[0]
            for g in range(1, 16):
                s = s + parts[g]
            out[p, :, b * db:(b + 1) * db] = s
    return out


def _k4_mirror(ob, Wd, TEre, TEim, PhiDre, PhiDim):
    """K4 as its bf16 kernels compute it. Wd pre-contraction, per row
    (p, b, t) and z: each of L = db / 8 lanes sums its 8 d in ascending
    order, the lanes (padded with zeros to a power of two) are added
    pairwise, neighbours first, and the sum is rounded to bf16. Then Abar =
    Rbar @ PhiDre and Bbar = -(Rbar @ PhiDim) with PhiD rounded to bf16,
    summed in f32, and the phase products added to g in ascending b."""
    PB, Tp, _ = ob.shape
    PT, DB, _, D2p, db = Wd.shape
    F = TEre.shape[-1]
    L = db // 8
    L2 = 1 << (L - 1).bit_length()
    W = Wd.astype(np.float32)
    phr, phi = _bf16f(PhiDre), _bf16f(PhiDim)
    gre = np.zeros((PB, Tp, F), np.float32)
    gim = np.zeros((PB, Tp, F), np.float32)
    for p in range(PB):
        pt = p % PT
        for b in range(DB):
            o = ob[p, :, b * db:(b + 1) * db]
            prod = (o[:, None, :] * W[pt, b]).reshape(Tp, D2p, L, 8)
            lanes = np.zeros((Tp, D2p, L2), np.float32)
            lanes[..., :L] = prod[..., 0]
            for i in range(1, 8):
                lanes[..., :L] = lanes[..., :L] + prod[..., i]
            while lanes.shape[-1] > 1:
                lanes = lanes[..., 0::2] + lanes[..., 1::2]
            Rbar = _bf16f(lanes[..., 0])  # [Tp, D2p]
            A = Rbar @ phr
            B = -(Rbar @ phi)
            er, ei = TEre[pt, b], TEim[pt, b]
            gre[p] = gre[p] + (A * er + B * ei)
            gim[p] = gim[p] + (-A * ei + B * er)
    return gre, gim


# (PB, PT, DB, Tp, D2p, db, F): PT = PB, the fan's one shared table set
# (PT = 1), PB = 2 PT; one to four detector blocks (three: the R stage's
# last pair half full); db of 8, 16 and 24 (three lanes padded to four);
# D2p of 16 and 32; odd F.
K34_SHAPES = [(3, 3, 2, 16, 32, 16, 21), (3, 1, 1, 8, 16, 8, 13),
              (4, 2, 2, 24, 16, 8, 21), (2, 1, 2, 16, 32, 16, 13),
              (2, 2, 1, 8, 16, 24, 13), (2, 2, 3, 8, 16, 8, 13),
              (2, 1, 4, 8, 32, 8, 21)]
K34_IDS = ["PT3-DB2-db16", "PT1-DB1-db8", "PB4-PT2-db8", "PT1-DB2-db16",
           "db24", "DB3", "PT1-DB4"]
K3_ARGS = ("gre", "gim", "Wd", "TEre", "TEim", "PhiDre", "PhiDim")
K4_ARGS = ("ob", "Wd", "TEre", "TEim", "PhiDre", "PhiDim")


@pytest.mark.parametrize("shape", K34_SHAPES, ids=K34_IDS)
def test_k3_kernel_algebra_matches_jax(shape):
    """The mirror of K3's kernels, and the port's plain version, against
    JAX's interpret-mode ``eval_shear`` (relative 2e-3 with bf16 tables: the
    sums run in another order, and a bf16 rounding of A or B can land on the
    other side)."""
    k = _k34_inputs(*shape, seed=21)
    want = jss.eval_shear(*(jnp.asarray(k[n]) for n in K3_ARGS))
    mirror = _k3_mirror(*(k[n] for n in K3_ARGS))
    plain = tss.eval_shear(*(_to_torch(k[n]) for n in K3_ARGS))
    assert mirror.shape == want.shape == tuple(plain.shape)
    _close(mirror, want, RTOL["bfloat16"])
    _close(plain, want, RTOL["bfloat16"])


@pytest.mark.parametrize("shape", K34_SHAPES, ids=K34_IDS)
def test_k4_kernel_algebra_matches_jax(shape):
    """The mirror of K4's kernels, and the port's plain version, against
    JAX's interpret-mode ``eval_shear_t`` (relative 2e-3 with bf16 tables:
    Rbar rounds to bf16 after sums taken in another order)."""
    k = _k34_inputs(*shape, seed=22)
    want = jss.eval_shear_t(*(jnp.asarray(k[n]) for n in K4_ARGS))
    mirror = _k4_mirror(*(k[n] for n in K4_ARGS))
    plain = tss.eval_shear_t(*(_to_torch(k[n]) for n in K4_ARGS))
    for m, pl_, w in zip(mirror, plain, want):
        _close(m, w, RTOL["bfloat16"])
        _close(pl_, w, RTOL["bfloat16"])


@pytest.mark.parametrize("shape", [K34_SHAPES[0], K34_SHAPES[1]],
                         ids=["PT=PB", "PT1"])
def test_k3_k4_mirrors_are_batch_invariant(shape):
    """Every output element of K3/K4 is summed in a fixed order from its
    own image and its table set alone: the mirrors on images 1..PB-1 (and,
    with PT = PB, their table sets), as a mesh rank's node block runs them,
    equal the mirrors on the whole batch bit for bit."""
    k = _k34_inputs(*shape, seed=23)
    PT = shape[1]
    loc = dict(k)
    for n in ("gre", "gim", "ob") + (("Wd", "TEre", "TEim") if PT > 1
                                      else ()):
        loc[n] = np.ascontiguousarray(k[n][1:])
    np.testing.assert_array_equal(_k3_mirror(*(loc[n] for n in K3_ARGS)),
                                  _k3_mirror(*(k[n] for n in K3_ARGS))[1:])
    for a, b in zip(_k4_mirror(*(loc[n] for n in K4_ARGS)),
                    _k4_mirror(*(k[n] for n in K4_ARGS))):
        np.testing.assert_array_equal(a, b[1:])


# ---------------------------------------------------------------------------
# The algebra of K7/K8's tensor-core kernels (bf16 tables), mirrored in
# numpy and held to the JAX package's kernels in interpret mode.


def _k78_inputs(PB, PT, NB, nb, TB, tt, planes, seed):
    """Shear tables of PT sets built as the loader builds them (two adjacent
    taps per (row block, slot, row) at a tap offset that rises along the
    rows, some all-zero slack slots, phases E of unit modulus, the twiddles
    Phi = W^{f d}), bf16 taps, a plane per angle block (``planes``: "mixed",
    sorted per table set, as the JAX transpose needs, or "one", each set on
    one plane), the two-plane row spectra of PB images and their slot
    cotangents. N = NB * nb, Np = 2N, so F = N + 1 is odd."""
    rng = np.random.default_rng(seed)
    N, Tp = NB * nb, TB * tt
    D2 = -(-(nb + 2) // 16) * 16
    F = N + 1
    slope = rng.uniform(0.0, 1.0, (PT, NB, Tp, 1))
    sig = slope * np.arange(nb) + rng.uniform(0.0, D2 - nb - 1.0,
                                              (PT, NB, Tp, 1))
    d0 = np.floor(sig).astype(np.int64)
    fr = (sig - d0).astype(np.float32)
    Wt = np.zeros((PT, NB, Tp, D2, nb), np.float32)
    i = np.indices(d0.shape)
    Wt[i[0], i[1], i[2], d0, i[3]] = 1.0 - fr
    Wt[i[0], i[1], i[2], d0 + 1, i[3]] += fr
    Wt[:, :, rng.random(Tp) < 0.2] = 0.0  # slack slots
    ph = rng.uniform(0.0, 2.0 * np.pi, (PT, NB, Tp, F))
    ang = 2.0 * np.pi / (2 * N) * np.outer(np.arange(D2), np.arange(F))
    if planes == "mixed":
        plane = np.sort(rng.integers(0, 2, (PT, TB)), axis=1)
    else:
        plane = np.tile((np.arange(PT) % 2)[:, None], (1, TB))
    plane = plane.astype(np.int32)
    pfirst = np.ones_like(plane)
    pfirst[:, 1:] = plane[:, 1:] != plane[:, :-1]
    pvisited = np.stack([(plane == s).any(axis=1) for s in (0, 1)], axis=1)
    return dict(
        rre2=rng.standard_normal((PB, 2, N, F)).astype(np.float32),
        rim2=rng.standard_normal((PB, 2, N, F)).astype(np.float32),
        gre=rng.standard_normal((PB, Tp, F)).astype(np.float32),
        gim=rng.standard_normal((PB, Tp, F)).astype(np.float32),
        Wt=_bf16(Wt), SEre=np.cos(ph).astype(np.float32),
        SEim=np.sin(ph).astype(np.float32),
        Phire=np.cos(ang).astype(np.float32),
        Phiim=np.sin(ang).astype(np.float32), plane=plane, pfirst=pfirst,
        pvisited=pvisited)


def _tap_tiles(W):
    """[..., D2/8, nb/8]: which 8 x 8 (taps, rows) tiles of the tap table W
    [..., D2, nb] hold a nonzero (the kernels' mask pass)."""
    D2, nb = W.shape[-2:]
    t = (W != 0).reshape(W.shape[:-2] + (D2 // 8, 8, nb // 8, 8))
    return t.any(axis=(-3, -1))


def _k7_tensor_core_mirror(rre2, rim2, Wt, SEre, SEim, Phire, Phiim, plane,
                           every_tile=False):
    """K7 as its bf16 tensor-core kernel computes it. Per (image p, angle
    block tb, row block b, slot t): the spectra rounded to bf16; S[d, f]
    summed in f32 over the (8 taps, 16 rows) tiles that the mask marks
    (``every_tile``: over all of them), 16-row chunks in ascending order
    for each 8-tap tile; the Phi combine in f32, each lane quad's four
    partial sums (taps 8j + 2q, 8j + 2q + 1 over ascending j) added by the
    shuffle tree; then E_b * T added to the running f32 sum in ascending
    b."""
    PB, _, N, F = rre2.shape
    PT, NB, Tp, D2, nb = Wt.shape
    TB = plane.shape[1]
    tt, DT, CH = Tp // TB, D2 // 8, -(-nb // 16)
    W = Wt.astype(np.float32)
    tiles = _tap_tiles(W)  # [PT, NB, Tp, DT, nb/8]
    mark = np.zeros(tiles.shape[:-1] + (CH,), bool)
    for c in range(CH):
        mark[..., c] = tiles[..., 2 * c:2 * c + 2].any(axis=-1)
    if every_tile:
        mark[:] = True
    phr, phi = Phire, Phiim
    gre = np.zeros((PB, Tp, F), np.float32)
    gim = np.zeros((PB, Tp, F), np.float32)
    for p in range(PB):
        pt = p % PT
        for tb in range(TB):
            ts = slice(tb * tt, (tb + 1) * tt)
            src = plane[pt, tb]
            for b in range(NB):
                rows = slice(b * nb, (b + 1) * nb)
                x = [np.zeros((16 * CH, F), np.float32) for _ in range(2)]
                x[0][:nb] = _bf16f(rre2[p, src, rows])
                x[1][:nb] = _bf16f(rim2[p, src, rows])
                Wp = np.zeros((tt, D2, 16 * CH), np.float32)
                Wp[..., :nb] = W[pt, b, ts]
                Tq = np.zeros((2, 4, tt, F), np.float32)  # (re/im, lane q)
                for j in range(DT):
                    S = np.zeros((2, tt, 8, F), np.float32)
                    for c in range(CH):
                        m = mark[pt, b, ts, j, c][:, None, None]
                        w = Wp[:, 8 * j:8 * j + 8, 16 * c:16 * c + 16]
                        for k in range(2):
                            prod = np.matmul(w, x[k][16 * c:16 * c + 16])
                            S[k] = np.where(m, S[k] + prod, S[k])
                    vis = mark[pt, b, ts, j].any(axis=-1)[:, None]
                    for q in range(4):
                        for e in range(2):
                            d = 8 * j + 2 * q + e
                            sr, si = S[0][:, 2 * q + e], S[1][:, 2 * q + e]
                            Tq[0, q] = np.where(
                                vis, Tq[0, q] + (sr * phr[d] - si * phi[d]),
                                Tq[0, q])
                            Tq[1, q] = np.where(
                                vis, Tq[1, q] + (sr * phi[d] + si * phr[d]),
                                Tq[1, q])
                Tr = (Tq[0, 0] + Tq[0, 1]) + (Tq[0, 2] + Tq[0, 3])
                Ti = (Tq[1, 0] + Tq[1, 1]) + (Tq[1, 2] + Tq[1, 3])
                er, ei = SEre[pt, b, ts], SEim[pt, b, ts]
                gre[p, ts] += Tr * er - Ti * ei
                gim[p, ts] += Tr * ei + Ti * er
    return gre, gim


def _k8_tensor_core_mirror(gre, gim, Wt, SEre, SEim, Phire, Phiim, plane,
                           every_tile=False):
    """K8 as its bf16 tensor-core kernel computes it. Per (image p, plane,
    row block b): for the angle blocks on the plane in ascending tb, each
    slot t and each (16 taps, 8 rows) tile that the mask marks (``every_
    tile``: all of them), in the order t, then taps: S = bf16(conj(Phi)
    conj(E_b) gbar) formed in f32, its product with the taps summed in f32
    into the plane's rows. A plane no angle block reads stays zero."""
    PB, Tp, F = gre.shape
    PT, NB, _, D2, nb = Wt.shape
    TB = plane.shape[1]
    tt, KJ = Tp // TB, D2 // 16
    W = Wt.astype(np.float32)
    tiles = _tap_tiles(W)  # [PT, NB, Tp, D2/8, nb/8]
    mark = tiles[..., 0::2, :] | tiles[..., 1::2, :]  # [.., KJ, nb/8]
    if every_tile:
        mark[:] = True
    mrow = np.repeat(mark, 8, axis=-1)[..., :nb]  # [.., KJ, nb]
    out = [np.zeros((PB, 2, NB * nb, F), np.float32) for _ in range(2)]
    for p in range(PB):
        pt = p % PT
        for b in range(NB):
            rows = slice(b * nb, (b + 1) * nb)
            for tb in range(TB):
                pl = plane[pt, tb]
                for t in range(tb * tt, (tb + 1) * tt):
                    er, ei = SEre[pt, b, t], SEim[pt, b, t]
                    g_r, g_i = gre[p, t], gim[p, t]
                    Tr = g_r * er + g_i * ei
                    Ti = g_i * er - g_r * ei
                    Sr = _bf16f(Tr * Phire + Ti * Phiim)  # [D2, F]
                    Si = _bf16f(Ti * Phire - Tr * Phiim)
                    for J in range(KJ):
                        ks = slice(16 * J, 16 * J + 16)
                        m = mrow[pt, b, t, J][:, None]
                        w = W[pt, b, t, ks].T  # [nb, 16]
                        for k, S in enumerate((Sr, Si)):
                            acc = out[k][p, pl, rows]
                            out[k][p, pl, rows] = np.where(
                                m, acc + w @ S[ks], acc)
    return out[0], out[1]


K78_ORDER = ("Wt", "SEre", "SEim", "Phire", "Phiim", "plane")
# (PB, PT, NB, nb, TB, tt, planes): 48-slot angle blocks on two and on four
# row blocks (nb = 8: a 16-row chunk half past the rows), 8-slot blocks on
# one shared table set (PT = 1) and on one row block, nodes on one plane.
K78_CASES = [(2, 2, 2, 16, 2, 48, "mixed"), (2, 2, 4, 8, 2, 8, "mixed"),
             (3, 1, 2, 16, 3, 8, "mixed"), (2, 2, 1, 16, 2, 8, "one")]
K78_IDS = ["tt48-NB2", "tt8-NB4-nb8", "tt8-PT1", "tt8-NB1-one-plane"]


@pytest.mark.parametrize("case", K78_CASES, ids=K78_IDS)
def test_k7_tensor_core_algebra_matches_jax(case):
    """The mirror of K7's tensor-core kernel, and the port's plain version,
    against JAX's interpret-mode ``shear_sum_planes`` (relative 2e-3 with
    bf16 tables: the sums run in another order)."""
    k = _k78_inputs(*case, seed=31)
    args = [k["rre2"], k["rim2"]] + [k[n] for n in K78_ORDER]
    want = jss.shear_sum_planes(*(jnp.asarray(a) for a in args))
    mirror = _k7_tensor_core_mirror(*args)
    plain = tss.shear_sum_planes(*(_to_torch(a) for a in args))
    for m, pl_, w in zip(mirror, plain, want):
        _close(m, w, RTOL["bfloat16"])
        _close(pl_, w, RTOL["bfloat16"])


@pytest.mark.parametrize("case", K78_CASES, ids=K78_IDS)
def test_k8_tensor_core_algebra_matches_jax(case):
    """The mirror of K8's tensor-core kernel, and the port's plain version,
    against JAX's interpret-mode ``shear_sum_planes_t`` (relative 2e-3 with
    bf16 tables: S rounds to bf16 from an f32 value whose last bit may
    differ); planes no angle block reads are zero."""
    k = _k78_inputs(*case, seed=32)
    args = [k["gre"], k["gim"]] + [k[n] for n in K78_ORDER]
    want = jss.shear_sum_planes_t(*(jnp.asarray(a) for a in args),
                                  jnp.asarray(k["pfirst"]))
    PB, PT = case[:2]
    vis = np.tile(k["pvisited"], (PB // PT, 1))[:, :, None, None]
    mirror = _k8_tensor_core_mirror(*args)
    plain = tss.shear_sum_planes_t(*(_to_torch(a) for a in args))
    for m, pl_, w in zip(mirror, plain, want):
        w = np.where(np.broadcast_to(vis, w.shape), np.asarray(w), 0.0)
        for got in (m, pl_.numpy()):
            _close(got, w, RTOL["bfloat16"])
            assert (got[~np.broadcast_to(vis, w.shape)] == 0).all()


@pytest.mark.parametrize("case", [K78_CASES[0], K78_CASES[1]],
                         ids=K78_IDS[:2])
def test_k7_k8_marked_tiles_equal_every_tile(case):
    """Skipping the unmarked tap tiles is exact on finite inputs: the
    mirrors over the marked tiles equal the mirrors over every tile bit for
    bit (a zero tile adds exact zeros)."""
    k = _k78_inputs(*case, seed=33)
    tabs = [k[n] for n in K78_ORDER]
    for mirror, pair in ((_k7_tensor_core_mirror, ("rre2", "rim2")),
                         (_k8_tensor_core_mirror, ("gre", "gim"))):
        args = [k[n] for n in pair] + tabs
        for a, b in zip(mirror(*args), mirror(*args, every_tile=True)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [K78_CASES[0], K78_CASES[2]],
                         ids=["PT=PB", "PT1"])
def test_k7_k8_mirrors_are_batch_invariant(case):
    """Every output element of K7/K8 is summed in a fixed order from its
    own image and its table set alone: the mirrors on images 1..PB-1 (and,
    with PT = PB, their table sets), as a node block runs them, equal the
    mirrors on the whole batch bit for bit."""
    k = _k78_inputs(*case, seed=34)
    PT = case[1]
    loc = dict(k)
    for n in ("rre2", "rim2", "gre", "gim") + (
            ("Wt", "SEre", "SEim", "plane") if PT > 1 else ()):
        loc[n] = np.ascontiguousarray(k[n][1:])
    for mirror, pair in ((_k7_tensor_core_mirror, ("rre2", "rim2")),
                         (_k8_tensor_core_mirror, ("gre", "gim"))):
        part = mirror(*(loc[n] for n in pair + K78_ORDER))
        whole = mirror(*(k[n] for n in pair + K78_ORDER))
        for a, b in zip(part, whole):
            np.testing.assert_array_equal(a, b[1:])
