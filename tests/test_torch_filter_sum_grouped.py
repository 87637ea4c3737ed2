"""The order of summation of the grouped filter-sum kernels K13/K14
(``csrc/filter_sum.cu`` ``grp_fwd``/``grp_t``), the images a thread takes,
and the pitched layout of the ``fft_grouped`` tables and of the operands
the projector hands them, on the CPU.

The CUDA kernels cannot run here, so numpy mirrors of their arithmetic in
f32 stand in for them, walking the kernels' blocks: K13 per group of K
images of one table set and chunk of 4 / K slots, eight row partials (warp
w sums rows n = w mod 8 in ascending n), added in warp order; K14 per group
of K images, one running sum per output element over the slot block's
slots in ascending t. Each complex product term is two fused multiply-adds
(``fmaf``) in the kernels' order, mirrored by a float64 product (exact)
and sum, rounded to float32 (a double rounding that can differ from
fmaf's single one in a last bit). Each mirror is held to the JAX
package's Pallas kernel in interpret mode at 1e-5 of the output's max,
with f32 and bf16 tables (a bf16 table is upcast exactly; only the order of
the f32 sums differs), at PB = PT and PB = k PT, and gives an image the
same rows bit for bit whatever the batch and the grouping. The plain
versions on pitched views equal those on contiguous copies bit for bit;
the ``fft_grouped`` build (parallel, and the fan path's ``shared.par``),
the slot spectra and cotangents the projector makes from it, and a mesh
rank's node slice of it are pitched, while ``fft_mxu``'s operands, which
share the slot helpers, stay dense."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops.pallas import filter_sum as jfs
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs
from dip_admm_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

RTOL = 1e-5
NG = 8  # K13's warps: the row partials
PAIRS = 4  # (slot, image) pairs a K13 thread sums
TB, TT, N, F = 2, 6, 24, 70  # slot blocks, slots (not a multiple of 4)
TP = TB * TT


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * scale)


def _inputs(dtype_name, PB, PT, seed=0):
    """H [2, PT, Tp, N, F] (rounded to the table type, as f32), slot
    spectra r [2, PB, TB, N, F] and cotangents g [2, PB, Tp, F], f32."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((2, PT, TP, N, F)).astype(np.float32)
    H = np.array(jnp.asarray(H).astype(jnp.dtype(dtype_name))
                 .astype(jnp.float32))
    r = rng.standard_normal((2, PB, TB, N, F)).astype(np.float32)
    g = rng.standard_normal((2, PB, TP, F)).astype(np.float32)
    return H, r, g


def _fma2(acc, x, y, z, w):
    """fmaf(z, w, fmaf(x, y, acc)) in float32, each product exact in
    float64, each sum rounded to float64, then to float32."""
    f64 = np.float64
    a = (x.astype(f64) * y + acc).astype(np.float32)
    return (z.astype(f64) * w + a).astype(np.float32)


def _groups(PB, PT, K):
    """The kernels' image groups: K images p = (k0 + k) PT + pt of table
    set pt."""
    return [[(k0 + k) * PT + pt for k in range(K)]
            for pt in range(PT) for k0 in range(0, PB // PT, K)]


def k13_mirror(rre, rim, Hre, Him, K=1):
    """K13's sums, block by block: per group of K images and chunk of
    4 / K slots, warp w's partial over rows n = w mod NG in ascending n,
    the partials added in warp order."""
    PB, PT = rre.shape[0], Hre.shape[0]
    A = PAIRS // K
    g_re = np.zeros((PB, TP, F), np.float32)
    g_im = np.zeros((PB, TP, F), np.float32)
    for imgs in _groups(PB, PT, K):
        pt = imgs[0] % PT
        for tb in range(TB):
            for c0 in range(0, TT, A):
                ts = np.arange(tb * TT + c0, tb * TT + min(TT, c0 + A))
                xr, xi = rre[imgs, tb][:, None], rim[imgs, tb][:, None]
                hr, hi = Hre[pt, ts][None], Him[pt, ts][None]
                sr = np.zeros((K, len(ts), F), np.float32)
                si = np.zeros((K, len(ts), F), np.float32)
                for w in range(NG):
                    ar = np.zeros_like(sr)
                    ai = np.zeros_like(si)
                    for n in range(w, N, NG):
                        vr, vi = xr[:, :, n], xi[:, :, n]
                        b, c = hr[:, :, n], hi[:, :, n]
                        ar = _fma2(ar, vr, b, -vi, c)
                        ai = _fma2(ai, vr, c, vi, b)
                    sr, si = sr + ar, si + ai
                g_re[np.ix_(imgs, ts)] = sr
                g_im[np.ix_(imgs, ts)] = si
    return g_re, g_im


def k14_mirror(gre, gim, Hre, Him, K=1):
    """K14's sums, per group of K images: one running sum per output
    element over its slot block's slots in ascending t."""
    PB, PT = gre.shape[0], Hre.shape[0]
    out_re = np.zeros((PB, TB, N, F), np.float32)
    out_im = np.zeros((PB, TB, N, F), np.float32)
    for imgs in _groups(PB, PT, K):
        pt = imgs[0] % PT
        for tb in range(TB):
            ar = np.zeros((K, N, F), np.float32)
            ai = np.zeros((K, N, F), np.float32)
            for t in range(tb * TT, (tb + 1) * TT):
                gr, gi = gre[imgs, t][:, None], gim[imgs, t][:, None]
                b, c = Hre[pt, t][None], Him[pt, t][None]
                ar = _fma2(ar, gr, b, gi, c)
                ai = _fma2(ai, gi, b, -gr, c)
            out_re[imgs, tb], out_im[imgs, tb] = ar, ai
    return out_re, out_im


def _jax_batched(fn, x, PB, PT):
    """fn over PB images against PT table sets, as the JAX package runs it
    (vmapped over PB // PT groups when PB > PT)."""
    if PB == PT:
        return fn(*x)
    xs = [a.reshape((PB // PT, PT) + a.shape[1:]) for a in x]
    return [np.asarray(o).reshape((PB,) + o.shape[2:])
            for o in jax.vmap(fn)(*xs)]


# (PB, PT, K): one table set per image, and two and four images a set,
# two to a thread, as the kernels group them at the fan shapes.
BATCHES = [(3, 3, 1), (4, 2, 2), (4, 1, 2)]
IDS = ["PB3PT3", "PB4PT2K2", "PB4PT1K2"]


@pytest.mark.parametrize("batch", BATCHES, ids=IDS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k13_mirror_matches_jax(dtype_name, batch):
    PB, PT, K = batch
    H, r, _ = _inputs(dtype_name, PB, PT)
    hj = [jnp.asarray(h).astype(jnp.dtype(dtype_name)) for h in H]
    want = _jax_batched(
        lambda a, b: jfs.filter_sum_grouped(a, b, hj[0], hj[1]),
        [jnp.asarray(r[0]), jnp.asarray(r[1])], PB, PT)
    for got, w in zip(k13_mirror(r[0], r[1], H[0], H[1], K), want):
        _close(got, w)


@pytest.mark.parametrize("batch", BATCHES, ids=IDS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k14_mirror_matches_jax(dtype_name, batch):
    PB, PT, K = batch
    H, _, g = _inputs(dtype_name, PB, PT)
    hj = [jnp.asarray(h).astype(jnp.dtype(dtype_name)) for h in H]
    mark = jnp.zeros((PT, TB, 2))
    want = _jax_batched(
        lambda a, b: jfs.filter_sum_grouped_t(a, b, hj[0], hj[1], mark),
        [jnp.asarray(g[0]), jnp.asarray(g[1])], PB, PT)
    for got, w in zip(k14_mirror(g[0], g[1], H[0], H[1], K), want):
        _close(got, w)


@pytest.mark.parametrize("mirror", ["k13", "k14"])
def test_mirrors_are_batch_and_grouping_invariant(mirror):
    """An image's rows do not depend on the rest of the batch or on how
    the images are grouped, bit for bit: image p of a four-image batch on
    one shared table set, grouped 1 or 2 to a thread, equals the same image
    alone, and a node slice (images 2, 3) equals those rows."""
    PB, PT = 4, 1
    H, r, g = _inputs("bfloat16", PB, PT)
    fn, x = (k13_mirror, r) if mirror == "k13" else (k14_mirror, g)
    whole = [fn(x[0], x[1], H[0], H[1], K) for K in (1, 2)]
    for out in whole[1:]:
        for a, b in zip(out, whole[0]):
            np.testing.assert_array_equal(a, b)
    half = fn(x[0][2:], x[1][2:], H[0], H[1], 2)
    for a, b in zip(half, whole[0]):
        np.testing.assert_array_equal(a, b[2:])
    for p in range(PB):
        alone = fn(x[0][p:p + 1], x[1][p:p + 1], H[0], H[1], 1)
        for a, b in zip(whole[0], alone):
            np.testing.assert_array_equal(a[p], b[0])


@pytest.mark.parametrize("PB,PT,K", [(8, 1, 2), (4, 1, 2), (8, 8, 1),
                                     (4, 4, 1), (6, 2, 1), (3, 1, 1)])
def test_grouped_images_pairs_the_images_of_a_table_set(PB, PT, K):
    """Two images a thread where the table set's images pair up (the fan
    paths, PT = 1, and a mesh rank's node slice of them), one where each
    image has its own set (the parallel paths) or PB / PT is odd."""
    assert tfs.grouped_images(PB, PT) == K


def _pitched(x):
    return tfs.pitched_zeros(x.shape, x.dtype, x.device).copy_(x)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_grouped_on_pitched_views_equals_contiguous(dtype_name):
    """The plain K13/K14 (the CPU path) on pitched tables, slot spectra and
    cotangents equal the same on contiguous copies bit for bit."""
    H, r, g = _inputs(dtype_name, 4, 2)
    dt = getattr(torch, dtype_name)
    Ht = [torch.as_tensor(h).to(dt) for h in H]
    rt = [torch.as_tensor(x) for x in r]
    gt = [torch.as_tensor(x) for x in g]
    Hp, rp, gp = ([_pitched(x) for x in xs] for xs in (Ht, rt, gt))
    assert Hp[0].stride(-2) == rp[0].stride(-2) == gp[0].stride(-2) == 72
    for a, b in zip(tfs.filter_sum_grouped(*rp, *Hp),
                    tfs.filter_sum_grouped(*rt, *Ht)):
        assert torch.equal(a, b)
    for a, b in zip(tfs.filter_sum_grouped_t(*gp, *Hp, TB),
                    tfs.filter_sum_grouped_t(*gt, *Ht, TB)):
        assert torch.equal(a, b)


GEO = dict(N=32, num_nodes=4, angles_total=40)


def _build(dtype_name, mode, fan=False):
    gt = tcfg.GeometryConfig(**GEO, fan_beam=fan)
    cfg = tcfg.ProblemConfig(geometry=gt, fft_table_dtype=dtype_name)
    a, v, _ = tradon.node_angles(gt)
    return gt, tloader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        mode)


def _assert_pitched(name, x, F, zero_pad=True):
    pitch = -(-F // tfs.PITCH) * tfs.PITCH
    assert pitch > F and x.shape[-1] == F, name
    assert tfs._check_pitched("test", name, x) == pitch, name
    full = tfs.padded(x)
    assert full.shape[-1] == pitch, name
    if zero_pad:
        pad = full[..., F:]
        assert torch.equal(pad, torch.zeros_like(pad)), name


@pytest.mark.parametrize("fan", [False, True], ids=["parallel", "fan"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grouped_build_tables_are_pitched(dtype_name, fan):
    """The loader's fft_grouped tables (parallel, and the fan path's
    shared ``par`` set): Hre_g/Him_g and the row-DFT columns pitched with
    zero pad columns, the irfft rows with zero padded F rows, the rest
    dense (their values against JAX's: ``test_torch_fan``)."""
    gt, tt = _build(dtype_name, "fft_grouped", fan)
    if fan:
        tt = tt["shared"]["par"]
    F = tt["Hre_g"].shape[-1]
    for k in ("Hre_g", "Him_g", "Ere", "Eim"):
        _assert_pitched(k, tt[k], F)
    for k in ("Cre", "Cim"):  # [P, F, Np]: F rows padded
        full = tfs.padded(tt[k], -2)
        assert full.shape[1] == -(-F // tfs.PITCH) * tfs.PITCH, k
        pad = full[:, F:]
        assert torch.equal(pad, torch.zeros_like(pad)), k
    for k in ("onehot", "posfull", "invposfull", "p", "s"):
        assert tt[k].is_contiguous(), k


def _old_slot_spectra(imgs, t):
    """The slot spectra as they were made before the grouped tables were
    pitched: a dense copy of the one-hot gather."""
    PT, TB = t["onehot"].shape[:2]
    PB, N = imgs.shape[:2]
    F = t["Ere"].shape[-1]
    return tuple(
        torch.einsum("kponf,pto->kptnf", tfft._kview(r, PT), t["onehot"])
        .reshape(PB, TB, N, F).contiguous()
        for r in tfft._plane_spectra(imgs, t))


def test_slot_operands_keep_the_pitch_of_grouped_tables():
    """``_slot_spectra`` (K13's input) and ``_slot_tail_t`` (K14's) come
    out pitched from fft_grouped tables, pad columns zero, equal to dense
    copies bit for bit."""
    gt, t = _build("bfloat16", "fft_grouped")
    rng = np.random.default_rng(1)
    imgs = torch.as_tensor(rng.standard_normal((4, gt.N, gt.N)),
                           dtype=torch.float32)
    sinos = torch.as_tensor(
        rng.standard_normal((4, t["p"].shape[1], gt.n_det)),
        dtype=torch.float32)
    F = t["Hre_g"].shape[-1]
    Tp = t["Hre_g"].shape[1]
    spectra = tfft._slot_spectra(imgs, t)
    cot = tfft._slot_tail_t(sinos, t)
    for x in (*spectra, *cot):
        _assert_pitched("operand", x, F)
    assert spectra[0].shape == (4, t["onehot"].shape[1], gt.N, F)
    assert cot[0].shape == (4, Tp, F)
    for a, b in zip(spectra, _old_slot_spectra(imgs, t)):
        assert torch.equal(a, b)


def test_slot_operands_of_mxu_stay_dense():
    """fft_mxu shares the slot helpers: its slot spectra and cotangents
    (K15/K16's inputs) stay contiguous at its padded F, equal bit for bit
    to the dense copies the helpers made before."""
    gt, t = _build("bfloat16", "fft_mxu")
    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.standard_normal((4, gt.N, gt.N)),
                           dtype=torch.float32)
    sinos = torch.as_tensor(
        rng.standard_normal((4, t["p"].shape[1], gt.n_det)),
        dtype=torch.float32)
    Fpad = t["Ere"].shape[-1]
    spectra = tfft._slot_spectra(imgs, t)
    cot = tfft._slot_tail_t(sinos, t)
    for x in (*spectra, *cot):
        assert x.is_contiguous() and x.shape[-1] == Fpad
    for a, b in zip(spectra, _old_slot_spectra(imgs, t)):
        assert torch.equal(a, b)
    g_bar = tfft._eval_tail_t(sinos, t)
    for a, b in zip(cot, g_bar):
        assert torch.equal(a, tfft._pad_unpermute(b, t).contiguous())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_slice_tables_keeps_the_grouped_pitch(dtype_name):
    """A mesh rank's node slice of the fft_grouped tables
    (``mesh.slice_tables``) keeps their pitched layout, its slot spectra
    and cotangents come out pitched, and the operators on the slice equal
    the whole batch's on those nodes; the fan path's shared ``par`` set is
    kept whole, pitched."""
    gt, tt = _build(dtype_name, "fft_grouped")
    ts = tmesh.slice_tables(tt, 4, slice(2, 4))
    F = tt["Hre_g"].shape[-1]
    for k in ("Hre_g", "Him_g", "Ere", "Eim"):
        _assert_pitched(k, ts[k], F)
        assert ts[k].data_ptr() == tt[k][2].data_ptr(), k  # a view
    rng = np.random.default_rng(3)
    imgs = torch.as_tensor(rng.standard_normal((4, gt.N, gt.N)),
                           dtype=torch.float32)
    sinos = torch.as_tensor(
        rng.standard_normal((4, tt["p"].shape[1], gt.n_det)),
        dtype=torch.float32)
    for x in (*tfft._slot_spectra(imgs[2:], ts),
              *tfft._slot_tail_t(sinos[2:], ts)):
        _assert_pitched("operand", x, F)
    for got, want in (
            (tfft.project_nodes_grouped(gt, imgs[2:], ts),
             tfft.project_nodes_grouped(gt, imgs, tt)[2:]),
            (tfft.backproject_nodes_grouped(gt, sinos[2:], ts),
             tfft.backproject_nodes_grouped(gt, sinos, tt)[2:])):
        _close(got.numpy(), want.numpy())
    _, tf = _build(dtype_name, "fft_grouped", fan=True)
    par = tmesh.slice_tables(tf, 4, slice(2, 4))["shared"]["par"]
    for k in ("Hre_g", "Him_g", "Ere", "Eim"):
        assert par[k] is tf["shared"]["par"][k], k
