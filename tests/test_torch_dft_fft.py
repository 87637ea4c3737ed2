"""The merged projectors' row DFTs and irfft tail as float32 FFTs, on the
CPU: ``radon_fft._plane_spectra``, ``_plane_spectra_t``, ``_eval_tail`` and
``_eval_tail_t`` against dense products with the exact DFT matrices in
float64, on the loader's ``fft_pallas`` (pitched), ``fft_grouped``
(pitched) and ``fft_mxu`` (dense at a padded F) tables, the tails through
either hat branch. ``_dft_mats`` rounds its phases (2 pi / Np) v f to
float32 before their cosines, which moves its entries by up to 1.5e-4 at
Np = 2048 (the dense products it fed were 3.7e-5 of their max off the
exact DFT at 512^2); the reference here reduces v f mod Np in integers
and takes the phases in float64.

Tolerances: each helper to 1e-5 of the output's max (a float32 FFT against
an exact product); the adjoint identity of each forward/transpose pair to
1e-5 relative. The columns past Np / 2 + 1 of every output, up to its
storage's row width, are exactly 0, and each plane is laid out as the
dense products laid it out: rows of the width of ``padded(Ere)`` (the
spectra) or of ``padded(Cre, -2)``'s F (the cotangents), dense over it,
32-byte aligned (both planes share one allocation)."""

import numpy as np
import pytest
import torch

from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs
from dip_admm_tpu_torch.utils import profiling

torch.set_num_threads(2)

RTOL = 1e-5
GEO = dict(N=32, num_nodes=4, angles_total=40)
MODES = ["fft_pallas", "fft_grouped", "fft_mxu"]
HELPERS = ["plane_spectra", "plane_spectra_t", "eval_tail", "eval_tail_t"]
# (helper, mode, hat branch of the tail): every helper on every build with
# the materialized hat weights, and the tails through K17/K18's plain
# versions (the branch the 512^2 builds take) on the fft_pallas build.
CASES = [(h, m, "weights") for h in HELPERS for m in MODES] + [
    (h, "fft_pallas", "on_the_fly") for h in ("eval_tail", "eval_tail_t")]


def _build(mode):
    gt = tcfg.GeometryConfig(**GEO)
    cfg = tcfg.ProblemConfig(geometry=gt, fft_table_dtype="bfloat16")
    a, v, _ = tradon.node_angles(gt)
    return gt, tloader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
        mode)


def _exact_dft(N, Np):
    """``_dft_mats``' four matrices in float64 with exact phases: Ere/Eim
    [N, Fd], Cre/Cim [Fd, Np] (interior bins doubled, over Np)."""
    Fd = Np // 2 + 1
    f = torch.arange(Fd, dtype=torch.int64)

    def cos_sin(a, b):
        ang = (2.0 * np.pi / Np) * ((a[:, None] * b[None, :]) % Np).double()
        return torch.cos(ang), torch.sin(ang)

    cos1, sin1 = cos_sin(torch.arange(N, dtype=torch.int64), f)
    cos2, sin2 = cos_sin(f, torch.arange(Np, dtype=torch.int64))
    c = torch.full((Fd, 1), 2.0, dtype=torch.float64)
    c[0] = c[-1] = 1.0
    return cos1, -sin1, c * cos2 / Np, -c * sin2 / Np


def _dense(t):
    """The exact DFT matrices at the tables' sizes (:func:`_exact_dft`)."""
    return _exact_dft(t["Ere"].shape[-2], tfft._dft_len(t))


def _hat64(t):
    Np = tfft._dft_len(t)
    v = torch.arange(Np, dtype=torch.float64)
    return torch.clamp(1.0 - torch.abs(t["p"].double()[..., None] - v),
                       min=0.0)


def _randn(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)


def _inputs(gt, t, helper, seed=0):
    PB, T, D = t["p"].shape
    N = gt.N
    if helper == "plane_spectra":
        return (_randn((PB, N, N), seed),)
    if helper == "plane_spectra_t":
        F = t["Ere"].shape[-1]
        return _randn((PB, 2, N, F), seed), _randn((PB, 2, N, F), seed + 1)
    if helper == "eval_tail":
        F = t["Cre"].shape[1]
        return _randn((PB, T, F), seed), _randn((PB, T, F), seed + 1)
    return (_randn((PB, T, D), seed),)


def _call(helper, t, args):
    if helper in ("plane_spectra", "eval_tail_t"):
        return getattr(tfft, "_" + helper)(*args, t)
    return getattr(tfft, "_" + helper)(*args, t, torch.float32)


def _want(helper, t, args):
    """The helper's map as dense float64 products, over the Fd = Np / 2 + 1
    bins (a wider input's columns past Fd meet the tables' zero pad)."""
    Ere, Eim, Cre, Cim = _dense(t)
    Fd = Cre.shape[0]
    a = [x.double() for x in args]
    if helper == "plane_spectra":
        rows2 = torch.stack([a[0], a[0].transpose(1, 2)], dim=1)
        return rows2 @ Ere, rows2 @ Eim
    if helper == "plane_spectra_t":
        rows2 = a[0][..., :Fd] @ Ere.T + a[1][..., :Fd] @ Eim.T
        return (rows2[:, 0] + rows2[:, 1].transpose(1, 2),)
    s = t["s"].double()[..., None]
    if helper == "eval_tail":
        g = a[0][..., :Fd] @ Cre + a[1][..., :Fd] @ Cim
        return (s * torch.einsum("ptdv,ptv->ptd", _hat64(t), g),)
    g_bar = torch.einsum("ptdv,ptd->ptv", _hat64(t), s * a[0])
    return g_bar @ Cre.T, g_bar @ Cim.T


def _assert_layout(helper, t, x):
    """Storage of the dense products' layout, zero past Fd."""
    Fd = tfft._dft_len(t) // 2 + 1
    if helper == "plane_spectra":
        F, W = t["Ere"].shape[-1], tfs.padded(t["Ere"]).shape[-1]
    else:
        F, W = t["Cre"].shape[1], tfs.padded(t["Cre"], -2).shape[-2]
    full = tfs.padded(x)
    assert x.shape[-1] == F and full.shape[-1] == W
    assert full.is_contiguous() and x.data_ptr() % 32 == 0
    pad = full[..., Fd:]
    assert torch.equal(pad, torch.zeros_like(pad))
    if W > F:  # pitched rows, as K11/K12/K13/K14 stream them
        assert tfs._check_pitched("test", helper, x) == W


@pytest.mark.parametrize("helper,mode,hat", CASES)
def test_fft_helper_matches_dense_dft_product(helper, mode, hat,
                                              monkeypatch):
    if hat == "on_the_fly":
        monkeypatch.setattr(tfft, "_HAT_MAX_BYTES", 0)
    gt, t = _build(mode)
    assert tfft._hat_on_the_fly(t) == (hat == "on_the_fly")
    args = _inputs(gt, t, helper)
    got = _call(helper, t, args)
    got = got if isinstance(got, tuple) else (got,)
    want = _want(helper, t, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        n = w.shape[-1]
        scale = float(w.abs().max())
        assert scale > 0
        np.testing.assert_allclose(g[..., :n].double().numpy(), w.numpy(),
                                   rtol=0, atol=RTOL * scale)
        if helper in ("plane_spectra", "eval_tail_t"):
            _assert_layout(helper, t, g)


def _dot(a, b):
    return float(sum(torch.sum(x.double() * y.double()) for x, y in zip(a, b)))


def _norm(a):
    return float(sum(torch.sum(x.double() ** 2) for x in a)) ** 0.5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pair", ["plane_spectra", "eval_tail"])
def test_fft_pair_adjoint_identity(pair, mode):
    """<A x, y> = <x, A^T y> for the row DFT and the irfft tail."""
    gt, t = _build(mode)
    x = _inputs(gt, t, pair, seed=3)
    y = _inputs(gt, t, pair + "_t", seed=5)
    Ax = _call(pair, t, x)
    Ax = Ax if isinstance(Ax, tuple) else (Ax,)
    Aty = _call(pair + "_t", t, y)
    Aty = Aty if isinstance(Aty, tuple) else (Aty,)
    rel = abs(_dot(Ax, y) - _dot(x, Aty)) / (_norm(Ax) * _norm(y))
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("mode,calls", [
    ("fft_pallas", 4), ("fft_grouped", 4), ("fft_mxu", 4), ("fft_shear", 2),
    ("fft_skew", 0)])
def test_proj_fft_counter(mode, calls):
    """``proj.fft`` counts each FFT helper a projector pair runs: all four
    on the merged tables, the row DFTs on fft_shear's, none on fft_skew's."""
    gt, t = _build(mode)
    fwd, adj = tloader.make_node_ops(mode, gt, t)
    PB, T, D = t["p"].shape if "p" in t else (
        GEO["num_nodes"], max(gt.angles_per_node()), gt.n_det)
    with profiling.recording() as rec:
        fwd(_randn((PB, gt.N * gt.N), 7))
        adj(_randn((PB, T * D), 8))
    assert rec.counts.get("proj.fft", 0) == calls
    assert rec.counts["proj.fwd"] == rec.counts["proj.adj"] == 1
