"""The order of summation of the select filter-sum kernels K11/K12
(``csrc/filter_sum.cu`` ``sel_fwd``/``sel_t``) and the pitched table layout
they stream, on the CPU.

The CUDA kernels cannot run here, so numpy mirrors of their arithmetic in
f32 stand in for them: K11 as eight row partials (warp w sums rows n = w
mod 8 in ascending n), added in warp order; K12 as one running sum per
output element, over plane 0's angles in ascending t, then plane 1's. Each
mirror is held to the JAX package's Pallas kernel in interpret mode at 1e-5
of the output's max, with f32 and bf16 tables (a bf16 table is upcast
exactly; only the order of the f32 sums differs), and is batch-invariant:
an image's result does not depend on the other images of the batch, bit for
bit. The plain versions on pitched views (``filter_sum.pitched_zeros``)
equal those on contiguous copies bit for bit, and the ``fft_pallas`` build
hands out pitched tables whose pad columns are zero, and a mesh rank's node
slice of them (``mesh.slice_tables``) keeps that layout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import filter_sum as jfs
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.parallel import mesh as tmesh
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs

torch.set_num_threads(2)

RTOL = 1e-5
NG = 8  # K11's warps: the row partials
T, N, F = 11, 27, 70  # angles (not a multiple of K11's 4), rows, frequencies


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * scale)


def _inputs(dtype_name, PB, PT, seed=0):
    """H [2, PT, T, N, F] (rounded to the table type, as f32), sel [PT, T,
    1] (set 0 all plane 0, set 1 all plane 1, the rest mixed), spectra r
    [2, PB, 2, N, F] and cotangents g [2, PB, T, F], f32."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((2, PT, T, N, F)).astype(np.float32)
    H = np.array(jnp.asarray(H).astype(jnp.dtype(dtype_name))
                 .astype(jnp.float32))
    sel = (rng.random((PT, T, 1)) > 0.5).astype(np.float32)
    sel[0] = 0.0
    if PT > 1:
        sel[1] = 1.0
    r = rng.standard_normal((2, PB, 2, N, F)).astype(np.float32)
    g = rng.standard_normal((2, PB, T, F)).astype(np.float32)
    return H, sel, r, g


def k11_mirror(rre2, rim2, Hre, Him, sel):
    """K11's sums: per image, warp w's partial over rows n = w mod NG in
    ascending n (each angle's selected plane), the partials added in warp
    order."""
    PB, PT = rre2.shape[0], Hre.shape[0]
    pt = np.arange(PB) % PT
    plane = (sel[pt, :, 0] > 0.5).astype(np.intp)  # [PB, T]
    pb = np.arange(PB)[:, None]
    xr, xi = rre2[pb, plane], rim2[pb, plane]  # [PB, T, N, F]
    hr, hi = Hre[pt], Him[pt]
    g_re = np.zeros((PB, T, F), np.float32)
    g_im = np.zeros((PB, T, F), np.float32)
    for w in range(NG):
        ar = np.zeros((PB, T, F), np.float32)
        ai = np.zeros((PB, T, F), np.float32)
        for n in range(w, N, NG):
            vr, vi, a, b = xr[:, :, n], xi[:, :, n], hr[:, :, n], hi[:, :, n]
            ar = ar + (vr * a - vi * b)
            ai = ai + (vr * b + vi * a)
        g_re, g_im = g_re + ar, g_im + ai
    return g_re, g_im


def k12_mirror(gre, gim, Hre, Him, sel):
    """K12's sums: per output element one running sum, over the angles that
    select its plane in ascending t."""
    PB, PT = gre.shape[0], Hre.shape[0]
    out_re = np.zeros((PB, 2, N, F), np.float32)
    out_im = np.zeros((PB, 2, N, F), np.float32)
    for p in range(PB):
        pt = p % PT
        for o in (0, 1):
            ar = np.zeros((N, F), np.float32)
            ai = np.zeros((N, F), np.float32)
            for t in range(T):
                if (sel[pt, t, 0] > 0.5) != bool(o):
                    continue
                gr, gi = gre[p, t][None], gim[p, t][None]
                a, b = Hre[pt, t], Him[pt, t]
                ar = ar + (gr * a + gi * b)
                ai = ai + (gi * a - gr * b)
            out_re[p, o], out_im[p, o] = ar, ai
    return out_re, out_im


def _jax_batched(fn, x, PB, PT):
    """fn over PB images against PT table sets, as the JAX package runs it
    (vmapped over PB // PT groups when PB > PT)."""
    if PB == PT:
        return fn(*x)
    xs = [a.reshape((PB // PT, PT) + a.shape[1:]) for a in x]
    return [np.asarray(o).reshape((PB,) + o.shape[2:])
            for o in jax.vmap(fn)(*xs)]


BATCHES = [(3, 3), (6, 2)]


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB6PT2"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k11_mirror_matches_jax(dtype_name, batch):
    PB, PT = batch
    H, sel, r, _ = _inputs(dtype_name, PB, PT)
    hj = [jnp.asarray(h).astype(jnp.dtype(dtype_name)) for h in H]
    want = _jax_batched(
        lambda a, b: jfs.filter_sum_sel(a, b, hj[0], hj[1], jnp.asarray(sel)),
        [jnp.asarray(r[0]), jnp.asarray(r[1])], PB, PT)
    for got, w in zip(k11_mirror(r[0], r[1], H[0], H[1], sel), want):
        _close(got, w)


@pytest.mark.parametrize("batch", BATCHES, ids=["PB3PT3", "PB6PT2"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k12_mirror_matches_jax(dtype_name, batch):
    PB, PT = batch
    H, sel, _, g = _inputs(dtype_name, PB, PT)
    hj = [jnp.asarray(h).astype(jnp.dtype(dtype_name)) for h in H]
    want = _jax_batched(
        lambda a, b: jfs.filter_sum_sel_t(a, b, hj[0], hj[1],
                                          jnp.asarray(sel)),
        [jnp.asarray(g[0]), jnp.asarray(g[1])], PB, PT)
    got = k12_mirror(g[0], g[1], H[0], H[1], sel)
    for a, w in zip(got, want):
        _close(a, w)
    # A plane that no angle of a single-branch table set selects is zero.
    for p in range(PB):
        if p % PT < 2:
            assert not got[0][p, 1 - p % PT].any()


@pytest.mark.parametrize("mirror", ["k11", "k12"])
def test_mirrors_are_batch_invariant(mirror):
    """An image's sums do not depend on the rest of the batch: image p of a
    six-image batch equals the same image alone against its table set."""
    PB, PT = 6, 2
    H, sel, r, g = _inputs("float32", PB, PT)
    if mirror == "k11":
        fn, x = k11_mirror, r
    else:
        fn, x = k12_mirror, g
    whole = fn(x[0], x[1], H[0], H[1], sel)
    for p in range(PB):
        pt = p % PT
        alone = fn(x[0][p:p + 1], x[1][p:p + 1], H[0][pt:pt + 1],
                   H[1][pt:pt + 1], sel[pt:pt + 1])
        for a, b in zip(whole, alone):
            np.testing.assert_array_equal(a[p], b[0])


def _pitched(x):
    return tfs.pitched_zeros(x.shape, x.dtype, x.device).copy_(x)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_sel_on_pitched_views_equals_contiguous(dtype_name):
    """The plain K11/K12 (the CPU path) on pitched tables, spectra and
    cotangents equal the same on contiguous copies bit for bit."""
    H, sel, r, g = _inputs(dtype_name, 6, 2)
    dt = getattr(torch, dtype_name)
    Ht = [torch.as_tensor(h).to(dt) for h in H]
    rt = [torch.as_tensor(x) for x in r]
    gt = [torch.as_tensor(x) for x in g]
    st = torch.as_tensor(sel)
    Hp, rp, gp = ([_pitched(x) for x in xs] for xs in (Ht, rt, gt))
    assert Hp[0].stride(-2) == rp[0].stride(-2) == gp[0].stride(-2) == 72
    for a, b in zip(tfs.filter_sum_sel(*rp, *Hp, st),
                    tfs.filter_sum_sel(*rt, *Ht, st)):
        assert torch.equal(a, b)
    for a, b in zip(tfs.filter_sum_sel_t(*gp, *Hp, st),
                    tfs.filter_sum_sel_t(*gt, *Ht, st)):
        assert torch.equal(a, b)


def test_pitched_zeros_layout():
    x = tfs.pitched_zeros((2, 3, 5, 33), torch.bfloat16, "cpu")
    assert x.shape == (2, 3, 5, 33)
    assert x.stride() == (3 * 5 * 40, 5 * 40, 40, 1)
    assert tfs._check_pitched("t", "x", x) == 40
    y = tfs.pitched_zeros((4, 16), torch.float32, "cpu")
    assert y.is_contiguous()  # F a multiple of 8: no padding


GEOS = {"N32P3": dict(N=32, num_nodes=3, angles_total=30),
        "N16P3": dict(N=16, num_nodes=3, angles_total=24)}


@pytest.mark.parametrize("geo", list(GEOS))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pallas_build_tables_are_pitched(dtype_name, geo):
    """The loader's fft_pallas tables: H and the row-DFT columns in pitched
    storage, the irfft rows in storage of the same padded F, all equal to
    JAX's merged tables where JAX has them (to the tolerance of
    ``test_torch_fft_pallas.test_merged_tables_match_jax``) and zero in the
    padding; the other tables dense."""
    gt = tcfg.GeometryConfig(**GEOS[geo])
    gj = jcfg.GeometryConfig(**dataclasses.asdict(gt))
    cfg = tcfg.ProblemConfig(geometry=gt, fft_table_dtype=dtype_name)
    a, v, _ = tradon.node_angles(gt)
    tt = tloader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        "fft_pallas")
    tj = jax.jit(jax.vmap(lambda aa, vv: jfft.precompute_merged(
        gj, aa, vv, table_dtype=jnp.dtype(dtype_name))))(
        jnp.asarray(a, jnp.float32), jnp.asarray(v))
    for k, x in tt.items():
        want = np.asarray(tj[k]).astype(np.float32)
        assert tuple(x.shape) == want.shape, k
        Fk = x.shape[-1]
        if k in ("Hre", "Him", "Ere", "Eim"):
            pitch = -(-Fk // tfs.PITCH) * tfs.PITCH
            assert tfs._check_pitched("build", k, x) == pitch, k
            full = tfs.padded(x)
            assert full.shape[-1] == pitch, k
            pad = full[..., Fk:]
            assert torch.equal(pad, torch.zeros_like(pad)), k
        elif k in ("Cre", "Cim"):  # [P, F, Np], F rows padded
            pitch = -(-x.shape[1] // tfs.PITCH) * tfs.PITCH
            assert x.stride() == (pitch * x.shape[2], x.shape[2], 1), k
            full = tfs.padded(x, -2)
            assert full.shape[1] == pitch, k
            pad = full[:, x.shape[1]:]
            assert torch.equal(pad, torch.zeros_like(pad)), k
        else:
            assert x.is_contiguous(), k
        got = x.float().numpy()
        tol = (2.0 ** -7 if x.dtype == torch.bfloat16 else RTOL)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30),
                                   err_msg=k)


def test_padded_widens_only_over_pitched_padding():
    """``filter_sum.padded`` widens a view over the zero padding of
    ``pitched_zeros``'s layout along either dim, and returns any other
    tensor as it is: dense, expanded (stride 0), transposed, or a pitched
    view whose storage ends before the padding."""
    x = tfs.pitched_zeros((3, 5, 33), torch.float32, "cpu")
    w = tfs.padded(x)
    assert w.shape == (3, 5, 40) and w.stride() == x.stride()
    assert w.data_ptr() == x.data_ptr()
    c = tfs.pitched_zeros((3, 33, 16), torch.float32, "cpu", dim=-2)
    assert c.stride() == (40 * 16, 16, 1)
    assert tfs.padded(c, -2).shape == (3, 40, 16)
    assert tfs.padded(x[1:]).shape == (2, 5, 40)  # a leading slice
    dense = torch.zeros((3, 5, 33))
    expanded = torch.zeros((1, 1, 33)).expand(3, 5, 33)
    flipped = torch.zeros((3, 40, 5)).transpose(1, 2)
    short = torch.zeros(2 * 40 + 33).as_strided((3, 33), (40, 1))
    for y in (dense, expanded, flipped, short, c):
        assert tfs.padded(y) is y
    assert tfs.padded(x, -2) is x


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_slice_tables_keeps_the_pitch(dtype_name):
    """A mesh rank's node slice of the fft_pallas tables
    (``mesh.slice_tables``) keeps their pitched layout: H and the row-DFT
    columns pass the kernels' stride check, the spectra and cotangents made
    from the slice come out pitched, and the operators on the slice equal
    the whole batch's on those nodes."""
    gt = tcfg.GeometryConfig(N=32, num_nodes=4, angles_total=40)
    cfg = tcfg.ProblemConfig(geometry=gt, fft_table_dtype=dtype_name)
    a, v, _ = tradon.node_angles(gt)
    tt = tloader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        "fft_pallas")
    ts = tmesh.slice_tables(tt, 4, slice(2, 4))
    Fk = tt["Hre"].shape[-1]
    pitch = -(-Fk // tfs.PITCH) * tfs.PITCH
    assert pitch > Fk
    for k in ("Hre", "Him", "Ere", "Eim"):
        assert tfs._check_pitched("slice", k, ts[k]) == pitch, k
    for k in ("Cre", "Cim"):
        assert tfs.padded(ts[k], -2).shape[1] == pitch, k
    rng = np.random.default_rng(3)
    T = tt["sel"].shape[1]
    imgs = torch.as_tensor(rng.standard_normal((4, gt.N, gt.N)),
                           dtype=torch.float32)
    sinos = torch.as_tensor(rng.standard_normal((4, T, gt.N)),
                            dtype=torch.float32)
    spectra = tfft._plane_spectra(imgs[2:], ts)
    cotangents = tfft._eval_tail_t(sinos[2:], ts)
    for x in (*spectra, *cotangents):
        assert x.shape[-1] == Fk
        assert tfs._check_pitched("slice", "operand", x) == pitch
    for got, want in (
            (tfft.project_nodes_merged(gt, imgs[2:], ts),
             tfft.project_nodes_merged(gt, imgs, tt)[2:]),
            (tfft.backproject_nodes_merged(gt, sinos[2:], ts),
             tfft.backproject_nodes_merged(gt, sinos, tt)[2:])):
        _close(got.numpy(), want.numpy())
