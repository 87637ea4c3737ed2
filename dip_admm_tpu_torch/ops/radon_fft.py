"""The parallel-beam projectors ``fft_skew``, ``fft_shear``,
``fft_grouped``, ``fft_pallas`` and ``fft_mxu``: their tables, the
forward/adjoint chains around their kernels, and exact column norms. The
fan-beam path (``ops/radon_fan.py``) runs ``fft_skew`` or ``fft_grouped``
as its parallel stage, on explicit detector positions (``dets``) and with
all of its node images against one shared table set.

For parallel-beam angle t (Joseph branch: integrate along the row axis a,
interpolate along the in-row axis) the interpolation coordinate is affine,
fb(t, l, a) = P(t, l) + B_t a + C_t. Each row is shifted by the real
sigma_{t,a} = B_t a + C_t (a 2-tap linear interpolation), the shifted rows
are summed, and the summed profile is evaluated at the detector grid
through a second 2-tap hat. Angles with |cos| > |sin| use the transposed
image (branch C). Within a row block the integer shifts span at most nb+1
consecutive values, so the shift tables factor exactly into real tap
weights, a per-(angle, block) phase ``SE`` and a shared matrix: ``fft_skew``
applies the taps ``WtT`` to the pixel rows and one DFT matrix ``D``;
``fft_shear`` applies the taps ``Wt`` to the row spectra and the twiddles
``Phi``. The evaluation tail factors the same way into ``Wd``, ``TE`` and
``PhiD``. See ``ops/kernels/shear_sum.py`` for the kernels.

``fft_pallas`` keeps the dense merged phase table H [P, T, N, F] instead,
with a per-angle selector of the image orientation, in pitched storage
(rows padded with zeros to a multiple of 8 elements,
``filter_sum.pitched_zeros``) so that its kernels stream H in 16-byte
loads; ``fft_grouped`` keeps it with its rows permuted into
branch-grouped slot order, pitched the same way, and ``fft_mxu`` so
permuted and pre-tiled with F padded to a multiple of 128. Around their
filter-sum kernels (``ops/kernels/filter_sum.py``, ``filter_mxu.py``) the
row DFT and the inverse DFT, and their transposes, are float32 torch FFTs
(the JAX package multiplies by the DFT matrices ``Ere``/``Eim``/``Cre``/
``Cim`` that the tables still hold, which fix Np, F and the row pitch of
the spectra and cotangents here), and the hat evaluation is a torch
product while its materialized weights stay below ``_HAT_MAX_BYTES``; past
that the hat kernels of ``ops/kernels/hat_eval.py`` evaluate it on the
fly, as in the JAX package.

The tables mirror ``dip_admm_tpu.ops.radon_fft.precompute_shear`` (one tap
layout per mode, as the JAX loader keeps them), ``precompute_merged``
(node-batched as the JAX loader builds it), ``precompute_grouped`` and
``precompute_merged_mxu``, and are built in float32 on the device the
caller names.

Node-shared tables: every projector takes PB images against tables of
batch PT that divides PB, image p using table set p % PT. The parallel
paths run PT = PB; the fan path PT = 1.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from dip_admm_tpu_torch.config import GeometryConfig
from dip_admm_tpu_torch.ops.kernels import filter_mxu
from dip_admm_tpu_torch.ops.kernels.filter_sum import (
    filter_sum_grouped, filter_sum_grouped_t, filter_sum_sel,
    filter_sum_sel_t, padded, pitched_zeros,
)
from dip_admm_tpu_torch.ops.kernels.hat_eval import hat_eval, hat_eval_t
from dip_admm_tpu_torch.ops.kernels.shear_sum import (
    eval_shear, eval_shear_t, shear_sum_planes, shear_sum_planes_t,
    skew_sum_planes, skew_sum_planes_t, skew_sum_planes_t_rows,
)
from dip_admm_tpu_torch.utils import profiling

# Window slack multiplier: Np >= (sqrt(2) + 1) * max(N, D) + margin keeps
# the circular interpolation reads alias-free.
_PAD_FACTOR = 2.5


def _padded_len(N: int, D: int) -> int:
    """Smallest power of two >= _PAD_FACTOR * max(N, D) + 8."""
    need = int(np.ceil(_PAD_FACTOR * max(N, D))) + 8
    return 1 << int(np.ceil(np.log2(need)))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding (the product of two float32
    values is exact in float64). XLA contracts these multiply-adds into
    fused ones, so the geometry agrees with the JAX package's tables to
    float32 precision instead of drifting by an ulp of sigma."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    return (a * b + c).to(torch.float32)


def _cos_sin(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of float32 ``x`` in float64, rounded once to float32:
    correctly rounded, as XLA's are (torch's float32 ones can be an ulp
    off, which moves a shift by an ulp of its magnitude)."""
    x64 = x.to(torch.float64)
    return torch.cos(x64).to(torch.float32), torch.sin(x64).to(torch.float32)


def _coeffs(cfg: GeometryConfig, angles: torch.Tensor, dets=None):
    """Coefficients of fb(t, l, a) = P(t, l) + B_t a + C_t for both Joseph
    branches, in float32 (pixel centres c(i) = -1 + (i+.5) h, detector
    centres likewise). ``angles`` [..., T] -> per branch (P [..., T, D],
    B, C, scale [..., T]) and the branch-R selector use_r [..., T].
    ``dets`` [D] replaces the uniform detector grid by explicit, possibly
    nonuniform positions (the fan-beam rebinned grid)."""
    N, D = cfg.N, cfg.n_det
    h = 2.0 / N
    if dets is None:
        det_w = cfg.det_width_factor * 2.0
        dd = det_w / D
        dets = _fma(
            torch.arange(D, dtype=torch.float32, device=angles.device) + 0.5,
            torch.tensor(dd, dtype=torch.float32), -det_w / 2.0,
        )
    else:
        dets = torch.as_tensor(dets, dtype=torch.float32, device=angles.device)
    c0 = -1.0 + 0.5 * h
    cos, sin = _cos_sin(angles)

    def branch(s, c):
        safe = torch.where(torch.abs(s) < 1e-9, 1e-9, s)
        P = dets / (h * safe[..., None])
        B = -(c / safe)
        C = _fma(torch.tensor(-c0, dtype=torch.float32), c / safe, 1.0) / h - 0.5
        scale = h / torch.abs(safe)
        return P, B, C, scale

    r = branch(sin, cos)
    c = branch(cos, sin)
    use_r = torch.abs(sin) >= torch.abs(cos)
    return r, c, use_r


def precompute_shear(
    cfg: GeometryConfig, angles: torch.Tensor, valid: torch.Tensor,
    table_dtype=torch.float32, nb: int = 128, dets=None,
    layout: str = "skew",
) -> dict:
    """Factored shear tables for :func:`project_nodes_skew` (``layout``
    "skew") or :func:`project_nodes_shear` ("shear").

    ``angles`` [P, T] float32 and ``valid`` [P, T] bool, on the device the
    tables are built on. ``nb`` caps the row block (largest multiple of 8
    dividing N, at most ``nb``; N itself if none). ``dets`` [D] moves only
    the eval tail's coordinates; its tap span D2p follows from the data.
    Each layout holds only what its mode reads, as the JAX loader keeps
    only one tap layout: "skew" the d-major taps ``WtT`` [P, NB, D2, Tp,
    nb] and the DFT-back matrices ``D*``; "shear" the t-major taps ``Wt``
    [P, NB, Tp, D2, nb], the tap twiddles ``Phire``/``Phiim`` [D2, F] and
    the row-DFT matrices ``Ere``/``Eim`` [P, N, F]."""
    if layout not in ("skew", "shear"):
        raise ValueError(f"precompute_shear: unknown layout {layout!r}")
    dev = angles.device
    P, T = angles.shape
    N, D = cfg.N, cfg.n_det
    Np = _padded_len(N, D)
    F = Np // 2 + 1
    want = min(nb, N)
    nb = N
    for cand in range(want, 7, -8):
        if N % cand == 0 and cand % 8 == 0:
            nb = cand
            break
    NB = N // nb
    D2 = -(-(nb + 2) // 16) * 16
    f32 = torch.float32

    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = _coeffs(
        cfg, angles.to(f32), dets
    )
    a_idx = torch.arange(N, dtype=f32, device=dev)
    d_r = torch.floor(Pr.min(dim=-1).values)  # [P, T]
    d_c = torch.floor(Pc.min(dim=-1).values)
    sig_r = _fma(Br[..., None], a_idx, Cr[..., None]) + d_r[..., None]
    sig_c = _fma(Bc[..., None], a_idx, Cc[..., None]) + d_c[..., None]
    ur = use_r[..., None]
    sigma = torch.where(ur, sig_r, sig_c)  # [P, T, N]
    p = torch.where(ur, Pr - d_r[..., None], Pc - d_c[..., None])  # [P,T,D]
    s = torch.where(use_r, sr, sc)

    plan = filter_mxu.plan_branch_groups(
        (~use_r).cpu().numpy(), valid.cpu().numpy(),
        tt_candidates=(48, 32, 16, 8),
    )
    Tp = int(plan["Tp"])
    src = torch.as_tensor(plan["src_slot"], device=dev).long()
    keep = (src >= 0).to(f32)  # [P, Tp]
    srcc = src.clamp(min=0)

    # ---- row stage: taps WtT [P, NB, D2, Tp, nb] and phases SE ----
    sigma_s = torch.gather(sigma, 1, srcc[:, :, None].expand(-1, -1, N))
    sigma_s = torch.where(keep[:, :, None] > 0, sigma_s, 0.0)  # [P, Tp, N]
    k = torch.floor(sigma_s).to(torch.int32)
    fr = sigma_s - torch.floor(sigma_s)
    kb = k.reshape(P, Tp, NB, nb)
    frb = fr.reshape(P, Tp, NB, nb)
    k0 = kb.min(dim=-1).values  # [P, Tp, NB]
    delta = kb - k0[..., None]  # in [0, nb]
    d_rng = torch.arange(D2, dtype=torch.int32, device=dev)
    w_tap = (
        (delta[..., None, :] == d_rng[:, None]) * (1.0 - frb[..., None, :])
        + (delta[..., None, :] + 1 == d_rng[:, None]) * frb[..., None, :]
    )  # [P, Tp, NB, D2, nb]
    w_tap = w_tap * keep[:, :, None, None, None]
    taps = w_tap.permute(*((0, 2, 3, 1, 4) if layout == "skew"
                           else (0, 2, 1, 3, 4))).to(table_dtype).contiguous()
    del w_tap

    f_idx = torch.arange(F, dtype=f32, device=dev)
    ang = (2.0 * math.pi / Np) * f_idx
    ph = ang * k0.to(f32)[..., None]  # [P, Tp, NB, F]
    SEre = torch.cos(ph).transpose(1, 2).contiguous()  # [P, NB, Tp, F]
    SEim = torch.sin(ph).transpose(1, 2).contiguous()
    del ph

    if layout == "skew":
        # DFT-back of the skew sum:
        # g[t, f] = E sum_v z[t, v] W^{-f (v-(D2-1))}.
        WZ = -(-(N + D2 - 1) // 128) * 128
        v = torch.arange(WZ, dtype=f32, device=dev) - float(D2 - 1)
        ang3 = (2.0 * math.pi / Np) * v[:, None] * f_idx[None, :]
        Dre = torch.cos(ang3).to(table_dtype)  # [WZ, F]
        Dim = (-torch.sin(ang3)).to(table_dtype)
        row_stage = {"WtT": taps}
        mats = {"Dre": Dre, "Dim": Dim, "DreT": Dre.T.contiguous(),
                "DimT": Dim.T.contiguous()}
    else:
        # Tap twiddles Phi[d, f] = W^{f d} and the row DFT of the spectra.
        ph_t = ang[None, :] * torch.arange(D2, dtype=f32, device=dev)[:, None]
        Ere, Eim = _dft_mats(N, Np, dev)[:2]
        row_stage = {"Wt": taps,
                     "Ere": Ere.expand(P, -1, -1).contiguous(),
                     "Eim": Eim.expand(P, -1, -1).contiguous()}
        mats = {"Phire": torch.cos(ph_t), "Phiim": torch.sin(ph_t)}

    # Per-block plane index; pure-slack blocks inherit the previous block's
    # plane, so the sequence is monotone per node.
    TBp = int(plan["onehot"].shape[1])
    tt_plan = int(plan["tt"])
    plane_np = np.argmax(plan["onehot"], axis=2).astype(np.int32)
    src_np = plan["src_slot"]
    for i in range(P):
        for bsl in range(1, TBp):
            if (src_np[i, bsl * tt_plan:(bsl + 1) * tt_plan] < 0).all():
                plane_np[i, bsl] = plane_np[i, bsl - 1]
    pfirst_np = np.zeros((P, TBp), np.int32)
    pfirst_np[:, 0] = 1
    pfirst_np[:, 1:] = (plane_np[:, 1:] != plane_np[:, :-1]).astype(np.int32)
    pvisited_np = np.zeros((P, 2), np.float32)
    for i in range(P):
        pvisited_np[i, np.unique(plane_np[i])] = 1.0

    # ---- eval tail: the same factorization along the detector axis ----
    db = D
    for cand in range(min(128, D), 7, -8):
        if D % cand == 0 and cand % 8 == 0:
            db = cand
            break
    DB = D // db
    s_valid = s * valid.to(f32)
    p_s = torch.gather(p, 1, srcc[:, :, None].expand(-1, -1, D))
    p_s = torch.where(keep[:, :, None] > 0, p_s, 0.0)  # [P, Tp, D]
    s_s = torch.gather(s_valid, 1, srcc) * keep
    kd = torch.floor(p_s).to(torch.int32).reshape(P, Tp, DB, db)
    frd = (p_s - torch.floor(p_s)).reshape(P, Tp, DB, db)
    k0d = kd.min(dim=-1).values  # [P, Tp, DB]
    deltad = kd - k0d[..., None]
    D2p = -(-(int(deltad.max()) + 2) // 16) * 16
    ddr = torch.arange(D2p, dtype=torch.int32, device=dev)
    wd = (
        (deltad[..., None, :] == ddr[:, None]) * (1.0 - frd[..., None, :])
        + (deltad[..., None, :] + 1 == ddr[:, None]) * frd[..., None, :]
    )  # [P, Tp, DB, D2p, db]
    wd = wd * s_s[:, :, None, None, None]
    Wd = wd.transpose(1, 2).to(table_dtype).contiguous()  # [P,DB,Tp,D2p,db]
    del wd
    cfac = torch.full((F,), 2.0 / Np, dtype=f32, device=dev)
    cfac[0] = 1.0 / Np
    cfac[-1] = 1.0 / Np
    ph = ang * k0d.to(f32)[..., None]  # [P, Tp, DB, F]
    TEre = (cfac * torch.cos(ph)).transpose(1, 2).contiguous()  # [P,DB,Tp,F]
    TEim = (cfac * torch.sin(ph)).transpose(1, 2).contiguous()
    ph_d = ang[None, :] * torch.arange(D2p, dtype=f32, device=dev)[:, None]

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    return {
        **row_stage,
        "SEre": SEre, "SEim": SEim,
        "Wd": Wd,
        "TEre": TEre, "TEim": TEim,
        "shared": {
            "PhiDre": torch.cos(ph_d), "PhiDim": torch.sin(ph_d), **mats,
        },
        "posfull": i32(plan["posfull"]),
        "invposfull": i32(plan["invposfull"]),
        "plane": i32(plane_np),
        # The JAX transpose kernels' plane bookkeeping (first visit, visited
        # planes). The port's K2 and K8 write every plane themselves and
        # read neither; they stay so the tables match the JAX package's.
        "pfirst": i32(pfirst_np),
        "pvisited": torch.as_tensor(pvisited_np, device=dev),
    }


def _pad_unpermute(bar: torch.Tensor, t: dict) -> torch.Tensor:
    """Transpose of ``permute_rows(x, posfull)[:, :T]``: zero-pad the T rows
    back to Tp slots and apply the inverse gather."""
    Tp = t["posfull"].shape[1]
    T = bar.shape[1]
    bar_full = torch.nn.functional.pad(bar, (0, 0, 0, Tp - T))
    return filter_mxu.permute_rows(bar_full, t["invposfull"])


def project_nodes_skew(cfg: GeometryConfig, imgs: torch.Tensor,
                       tables: dict, n_rows: int | None = None) -> torch.Tensor:
    """Batched forward projection [PB, N, N] -> [PB, T, D]: the skew row
    stage (K1), the factored eval tail (K3) and the slot unpermute.
    ``n_rows`` overrides the per-node angle count T (the fan rebin runs this
    stage on T_fan/2 shared parallel angles)."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_skew supports parallel beam only")
    t = tables
    sh = t["shared"]
    T = max(cfg.angles_per_node()) if n_rows is None else n_rows
    dtype = imgs.dtype
    imgs = imgs.to(torch.float32)
    rows2 = torch.stack([imgs, imgs.transpose(1, 2)], dim=1).contiguous()
    g_re, g_im = skew_sum_planes(
        rows2, t["WtT"], t["SEre"], t["SEim"], sh["Dre"], sh["Dim"],
        t["plane"],
    )
    out_slot = eval_shear(
        g_re, g_im, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"]
    )  # [P, Tp, D] in slot order
    return filter_mxu.permute_rows(out_slot, t["posfull"])[:, :T].to(dtype)


def backproject_nodes_skew(cfg: GeometryConfig, sinos: torch.Tensor,
                           tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_skew`, composed by hand: slot
    re-permute, eval-tail transpose (K4), skew transpose (K2), plane sum.
    ``sinos`` [PB, T, D]; T may be below the slot count Tp."""
    t = tables
    sh = t["shared"]
    ob = _pad_unpermute(sinos.to(torch.float32), t).contiguous()
    g_re_bar, g_im_bar = eval_shear_t(
        ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"]
    )
    rows2_bar = skew_sum_planes_t(
        g_re_bar, g_im_bar, t["WtT"], t["SEre"], t["SEim"],
        sh["DreT"], sh["DimT"], t["plane"],
    )
    return (rows2_bar[:, 0] + rows2_bar[:, 1].transpose(1, 2)).to(sinos.dtype)


class RowShard(NamedTuple):
    """One pixel shard of the row-sharded skew projector: its position on
    the pixel axis and that axis's two collectives, in place of the JAX
    package's ``axis_name``. The shard's tables carry only its NB_loc row
    blocks of ``WtT``/``SEre``/``SEim``; the shards own consecutive row
    blocks in the order of ``index``."""

    index: int
    psum: Callable[[torch.Tensor], torch.Tensor]  # sum over the pixel axis
    # (t, dim) -> the shards' t concatenated along dim, in index order
    gather: Callable[[torch.Tensor, int], torch.Tensor]


def project_nodes_skew_rowshard(cfg: GeometryConfig, imgs: torch.Tensor,
                                tables: dict, shard: RowShard,
                                n_rows: int | None = None) -> torch.Tensor:
    """:func:`project_nodes_skew` with the row stage split over the pixel
    axis: K1 on this shard's rows [r0, r0 + NB_loc * nb) of both planes
    (its tap product, the projector's bulk, divides by the shard count),
    one pixel-axis sum of the slot spectra, then the eval tail (K3),
    replicated on every shard."""
    t = tables
    sh = t["shared"]
    T = max(cfg.angles_per_node()) if n_rows is None else n_rows
    dtype = imgs.dtype
    NB_loc, nb = t["WtT"].shape[1], t["WtT"].shape[-1]
    r0 = shard.index * NB_loc * nb
    imgs = imgs.to(torch.float32)
    rows2 = torch.stack([imgs[:, r0:r0 + NB_loc * nb],
                         imgs.transpose(1, 2)[:, r0:r0 + NB_loc * nb]], dim=1)
    g = torch.stack(skew_sum_planes(
        rows2.contiguous(), t["WtT"], t["SEre"], t["SEim"], sh["Dre"],
        sh["Dim"], t["plane"],
    ))
    g_re, g_im = shard.psum(g)
    out_slot = eval_shear(
        g_re.contiguous(), g_im.contiguous(), t["Wd"], t["TEre"], t["TEim"],
        sh["PhiDre"], sh["PhiDim"],
    )
    return filter_mxu.permute_rows(out_slot, t["posfull"])[:, :T].to(dtype)


def backproject_nodes_skew_rowshard(cfg: GeometryConfig, sinos: torch.Tensor,
                                    tables: dict,
                                    shard: RowShard) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_skew_rowshard`: the eval-tail
    transpose (K4) replicated, K6 on this shard's row blocks at the full row
    width, and one pixel-axis all-gather of the row blocks. K6 writes zeros
    to a plane that no angle block reads, as K2 does, so the JAX package's
    ``pvisited`` mask has nothing left to clear."""
    t = tables
    sh = t["shared"]
    ob = _pad_unpermute(sinos.to(torch.float32), t).contiguous()
    g_re_bar, g_im_bar = eval_shear_t(
        ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"]
    )
    rows2_bar = shard.gather(skew_sum_planes_t_rows(
        g_re_bar, g_im_bar, t["WtT"], t["SEre"], t["SEim"],
        sh["DreT"], sh["DimT"], t["plane"], cfg.N,
    ), 2)  # [PB, 2, N, N]
    return (rows2_bar[:, 0] + rows2_bar[:, 1].transpose(1, 2)).to(sinos.dtype)


def project_nodes_shear(cfg: GeometryConfig, imgs: torch.Tensor,
                        tables: dict) -> torch.Tensor:
    """Batched forward projection [PB, N, N] -> [PB, T, D] on the "shear"
    layout of :func:`precompute_shear`: row DFTs, the spectral shear row
    stage (K7), the factored eval tail (K3) and the slot unpermute.
    Parallel beam only."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_shear supports parallel beam only")
    t = tables
    sh = t["shared"]
    T = max(cfg.angles_per_node())
    rre2, rim2 = _plane_spectra(imgs, t)
    g_re, g_im = shear_sum_planes(
        rre2.contiguous(), rim2.contiguous(), t["Wt"], t["SEre"], t["SEim"],
        sh["Phire"], sh["Phiim"], t["plane"],
    )
    out_slot = eval_shear(
        g_re, g_im, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"]
    )  # [P, Tp, D] in slot order
    return filter_mxu.permute_rows(out_slot, t["posfull"])[:, :T].to(
        imgs.dtype)


def backproject_nodes_shear(cfg: GeometryConfig, sinos: torch.Tensor,
                            tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_shear`, composed by hand: slot
    re-permute, eval-tail transpose (K4), shear transpose (K8) and the
    row-DFT transpose. K8 writes zeros to a plane that no angle block
    reads, which is what the JAX chain's ``pvisited`` mask does."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_shear supports parallel beam only")
    t = tables
    sh = t["shared"]
    ob = _pad_unpermute(sinos.to(torch.float32), t).contiguous()
    g_re_bar, g_im_bar = eval_shear_t(
        ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"]
    )
    rre2_bar, rim2_bar = shear_sum_planes_t(
        g_re_bar, g_im_bar, t["Wt"], t["SEre"], t["SEim"], sh["Phire"],
        sh["Phiim"], t["plane"],
    )
    return _plane_spectra_t(rre2_bar, rim2_bar, t, sinos.dtype)


# ---------------------------------------------------------------------------
# fft_pallas, fft_grouped and fft_mxu: merged phase tables
# ---------------------------------------------------------------------------

# Past this many bytes of materialized hat weights w [PT, T, D, Np] the eval
# tail runs the on-the-fly hat kernels K17/K18 instead of the einsums (the
# JAX package's rule and threshold; 512^2/8 parallel beam is past it).
_HAT_MAX_BYTES = 1.5e9


def _dft_mats(N: int, Np: int, device=None):
    """DFT matrices that stand for rfft/irfft as matmuls: the forward DFT
    of rows zero-padded N -> Np (its first N rows), Ere/Eim [N, F], and
    the irfft coefficients Cre/Cim [F, Np] (interior bins doubled, the
    imaginary parts of DC and Nyquist dropped). The phases are rounded to
    float32 before their cosines, as the JAX package's are: at Np = 2048
    an entry is up to 1.5e-4 off the exact DFT. The merged projectors
    apply these maps as FFTs (:func:`_plane_spectra`, :func:`_eval_tail`
    and their transposes) and read only the matrices' shapes and pitch."""
    f32 = torch.float32
    F = Np // 2 + 1
    f = torch.arange(F, dtype=f32, device=device)
    v = torch.arange(N, dtype=f32, device=device)
    Ere, Eim = _cos_sin((2.0 * math.pi / Np) * v[:, None] * f[None, :])
    c = torch.full((F,), 2.0, dtype=f32, device=device)
    c[0] = 1.0
    c[-1] = 1.0
    vv = torch.arange(Np, dtype=f32, device=device)
    cos2, sin2 = _cos_sin((2.0 * math.pi / Np) * f[:, None] * vv[None, :])
    Np_ = torch.tensor(float(Np), dtype=f32, device=device)
    return Ere, -Eim, c[:, None] * cos2 / Np_, -c[:, None] * sin2 / Np_


def _branch_phases(P, B, C, N: int, Np: int, mask):
    """Shift-filter phase table H [T, N, F] of one branch, as (re, im):
    H = e^{i w k} ((1 - fr) + fr e^{i w}) at the row shift k + fr = sigma,
    w = 2 pi f / Np; rows of angles outside ``mask`` are zero."""
    dev = B.device
    f32 = torch.float32
    F = Np // 2 + 1
    f = torch.arange(F, dtype=f32, device=dev)
    a_idx = torch.arange(N, dtype=f32, device=dev)
    delta = torch.floor(P.min(dim=1).values)  # [T]
    sigma = _fma(B[:, None], a_idx, C[:, None]) + delta[:, None]  # [T, N]
    k = torch.floor(sigma)
    fr = (sigma - k)[:, :, None]
    ang = (2.0 * math.pi / Np) * f  # [F]
    bre, bim = _cos_sin(ang * k[:, :, None])  # [T, N, F]
    ca, sa = _cos_sin(ang)
    tre = (1.0 - fr) + fr * ca
    tim = fr * sa
    m = mask[:, None, None]
    return (bre * tre - bim * tim) * m, (bre * tim + bim * tre) * m, delta


def precompute_merged(cfg: GeometryConfig, angles: torch.Tensor,
                      valid: torch.Tensor, table_dtype=torch.float32,
                      dets=None) -> dict:
    """Branch-merged tables of one node (``angles``, ``valid`` [T]): one
    phase table pair H [T, N, F] (per angle exactly one branch is nonzero),
    the selector ``sel`` [T, 1] (1 = the transposed image's spectrum), the
    recentred evaluation coordinates ``p`` [T, D], the branch scale ``s``
    [T] and the DFT matrices."""
    N = cfg.N
    Np = _padded_len(N, cfg.n_det)
    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = _coeffs(
        cfg, angles.to(torch.float32), dets
    )
    vm = valid.to(torch.float32)
    m_r = use_r.to(torch.float32) * vm
    m_c = (1.0 - use_r.to(torch.float32)) * vm
    Hr_re, Hr_im, d_r = _branch_phases(Pr, Br, Cr, N, Np, m_r)
    Hc_re, Hc_im, d_c = _branch_phases(Pc, Bc, Cc, N, Np, m_c)
    Ere, Eim, Cre, Cim = _dft_mats(N, Np, angles.device)
    return {
        "Hre": (Hr_re + Hc_re).to(table_dtype),
        "Him": (Hr_im + Hc_im).to(table_dtype),
        "p": torch.where(use_r[:, None], Pr - d_r[:, None], Pc - d_c[:, None]),
        "s": torch.where(use_r, sr, sc),
        "sel": m_c[:, None],
        "Ere": Ere, "Eim": Eim, "Cre": Cre, "Cim": Cim,
    }


def precompute_merged_nodes(cfg: GeometryConfig, angles: torch.Tensor,
                            valid: torch.Tensor, table_dtype=torch.float32,
                            dets=None, pitched: bool = False) -> dict:
    """Node-batched :func:`precompute_merged` tables for
    :func:`project_nodes_merged` (``angles``, ``valid`` [P, T]): each
    node's tables written into the batch, as the JAX loader vmaps them.
    ``pitched`` (the ``fft_pallas`` build) puts H and the row-DFT columns
    ``Ere``/``Eim`` in pitched storage (:func:`filter_sum.pitched_zeros`),
    and the irfft rows ``Cre``/``Cim`` [P, F, Np] in storage of the same
    padded F with zero rows, all still handed out at their shapes: K11/K12
    stream the rows of H, of the spectra (which take the pitch of
    ``Ere``/``Eim``) and of the spectrum cotangents (that of ``Cre``/
    ``Cim``) in 16-byte loads. Each node is written into the batch storage
    as it is built, so no table is held twice."""
    return _node_batch(angles.shape[0], lambda i: precompute_merged(
        cfg, angles[i], valid[i], table_dtype, dets), pitched)


def _batch_storage(key, shape, like, pitched):
    """Storage for the batch of table ``key``: pitched rows for H and the
    row-DFT columns, padded F rows for the irfft rows (``pitched``)."""
    kw = dict(dtype=like.dtype, device=like.device)
    if pitched and key in ("Hre", "Him", "Ere", "Eim"):
        return pitched_zeros(shape, **kw)
    if pitched and key in ("Cre", "Cim"):  # [P, F, Np]: F rows padded
        return pitched_zeros(shape, dim=-2, **kw)
    return torch.empty(shape, **kw)


# Fold the irfft + hat + scale tail into the WC tables only up to this many
# bytes of them (both planes, in the table dtype): the JAX package's cap.
_FOLD_EVAL_MAX_BYTES = 4.0e9


def precompute_grouped(cfg: GeometryConfig, angles: torch.Tensor,
                       valid: torch.Tensor, table_dtype=torch.float32,
                       fold_eval: bool | None = None, dets=None) -> dict:
    """Branch-grouped merged tables for :func:`project_nodes_grouped`:
    each node's :func:`precompute_merged` tables, the H rows permuted into
    ``plan_branch_groups`` slot order (every tt-angle block single-branch,
    slack rows zero). ``angles``, ``valid`` [P, T]. The tables are pitched
    as the ``fft_pallas`` build's are (:func:`precompute_merged_nodes`
    with ``pitched``): ``Hre_g``/``Him_g`` and the row-DFT columns in
    pitched storage, the irfft rows with their F rows padded, so that K13
    and K14 stream H, the slot spectra and the cotangents in 16-byte loads.

    ``fold_eval`` (off by default, as in the JAX package, which measured
    it slower) also folds the irfft, the hat evaluation and the branch
    scale into one table pair per plane, in slot order, slack rows zero:

        WC_re[p, t, d, f] = s[p, t] sum_v hat(p[p, t, d] - v) Cre[p, f, v]

    (dense [P, Tp, D, F] in the table dtype, built one angle block at a
    time), so that the tail after K13 is one contraction over f. It is
    dropped, as there, when the pair would pass ``_FOLD_EVAL_MAX_BYTES``."""
    merged = precompute_merged_nodes(cfg, angles, valid, table_dtype, dets,
                                     pitched=True)
    use_c = merged["sel"][:, :, 0] > 0.5
    plan = filter_mxu.plan_branch_groups(use_c.cpu().numpy(),
                                         valid.cpu().numpy())
    dev = angles.device
    src = torch.as_tensor(plan["src_slot"], device=dev).long()
    keep = (src >= 0)[:, :, None, None].to(table_dtype)

    def slots(H):
        """H's rows in slot order, gathered over its padded width (the pad
        columns stay zero), as the pitched [P, Tp, N, F] view."""
        full = padded(H)
        idx = src.clamp(min=0)[:, :, None, None].expand(-1, -1,
                                                         *full.shape[2:])
        return torch.gather(full, 1, idx).mul_(keep)[..., :H.shape[-1]]

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    tables = {
        "Hre_g": slots(merged.pop("Hre")),
        "Him_g": slots(merged.pop("Him")),
        "onehot": torch.as_tensor(plan["onehot"], device=dev),
        "posfull": i32(plan["posfull"]),
        "invposfull": i32(plan["invposfull"]),
        **{k: merged[k] for k in ("p", "s", "Ere", "Eim", "Cre", "Cim")},
    }
    P, Tp = src.shape
    D, F = merged["p"].shape[-1], merged["Cre"].shape[-2]
    wc_bytes = 2 * P * Tp * D * F * torch.finfo(table_dtype).bits // 8
    if fold_eval and wc_bytes <= _FOLD_EVAL_MAX_BYTES:
        tables.update(_fold_tables(merged, src, int(plan["tt"]), table_dtype))
    return tables


def _fold_tables(merged: dict, src: torch.Tensor, tt: int,
                 table_dtype) -> dict:
    """The WC pair of :func:`precompute_grouped`'s ``fold_eval``: the
    slot-ordered coordinates and scales (slack slots s = 0, so their rows
    are zero), one tt-angle block at a time, so that the transient hat
    weights are [P, tt, D, Np] and not [P, Tp, D, Np]."""
    P, Tp = src.shape
    D = merged["p"].shape[-1]
    Cre, Cim = merged["Cre"], merged["Cim"]  # [P, F, Np]
    F, Np = Cre.shape[-2:]
    keep = (src >= 0).to(torch.float32)
    srcc = src.clamp(min=0)
    p_slot = torch.gather(merged["p"], 1, srcc[:, :, None].expand(-1, -1, D))
    s_slot = torch.gather(merged["s"], 1, srcc) * keep
    v_idx = torch.arange(Np, dtype=torch.float32, device=src.device)
    out = {k: torch.empty((P, Tp, D, F), dtype=table_dtype, device=src.device)
           for k in ("WCre", "WCim")}
    for t0 in range(0, Tp, tt):
        w = torch.clamp(1.0 - torch.abs(p_slot[:, t0:t0 + tt, :, None]
                                        - v_idx), min=0.0)
        sc = s_slot[:, t0:t0 + tt, None, None]
        for key, C in (("WCre", Cre), ("WCim", Cim)):
            out[key][:, t0:t0 + tt] = sc * torch.einsum("ptdv,pfv->ptdf", w, C)
        del w
    return out


def precompute_merged_mxu(cfg: GeometryConfig, angles: torch.Tensor,
                          valid: torch.Tensor,
                          table_dtype=torch.float32) -> dict:
    """Tiled branch-grouped tables for :func:`project_nodes_mxu`: each
    node's :func:`precompute_merged` tables, the H rows in
    ``plan_branch_groups`` slot order and tiled to [P, Fpad/128, N/tn, Tp,
    tn*128] (``filter_mxu.tile_table``), F padded with zeros to Fpad =
    ceil(F/128)*128 in the table, the row-DFT columns ``Ere``/``Eim`` and
    the irfft rows ``Cre``/``Cim``. ``p``/``s`` stay in angle order; the
    projector unpermutes the spectra after the kernel."""
    merged = precompute_merged_nodes(cfg, angles, valid, table_dtype)
    use_c = merged["sel"][:, :, 0] > 0.5
    plan = filter_mxu.plan_branch_groups(use_c.cpu().numpy(),
                                         valid.cpu().numpy())
    dev = angles.device
    F = merged["Hre"].shape[-1]
    Fpad = -(-F // 128) * 128
    tn = filter_mxu.pick_tn(cfg.N)
    src = torch.as_tensor(plan["src_slot"], device=dev)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    pad_cols = (0, Fpad - F)
    pad_rows = (0, 0, 0, Fpad - F)
    return {
        "Hre_t": filter_mxu.tile_table(merged.pop("Hre"), src, Fpad, tn),
        "Him_t": filter_mxu.tile_table(merged.pop("Him"), src, Fpad, tn),
        "onehot": torch.as_tensor(plan["onehot"], device=dev),
        "posfull": i32(plan["posfull"]),
        "invposfull": i32(plan["invposfull"]),
        "p": merged["p"], "s": merged["s"],
        "Ere": torch.nn.functional.pad(merged["Ere"], pad_cols),
        "Eim": torch.nn.functional.pad(merged["Eim"], pad_cols),
        "Cre": torch.nn.functional.pad(merged["Cre"], pad_rows),
        "Cim": torch.nn.functional.pad(merged["Cim"], pad_rows),
    }


def _kview(x: torch.Tensor, PT: int) -> torch.Tensor:
    """[PB, ...] -> [PB // PT, PT, ...]: image p = k * PT + (p % PT)."""
    return x.reshape(x.shape[0] // PT, PT, *x.shape[1:])


def _dft_len(t) -> int:
    """Np, the length the row DFTs pad the rows to: the irfft rows' length
    (the merged tables), or 2 (F - 1) from the unpadded row-DFT columns
    of the "shear" tables, which have no irfft rows."""
    if "Cre" in t:
        return t["Cre"].shape[-1]
    return 2 * (t["Ere"].shape[-1] - 1)


@functools.lru_cache(maxsize=None)
def _dft_weights(Np: int, device: torch.device) -> dict:
    """Per-bin weights [2, F] (real part, imaginary part) that the FFT
    forms of the merged tables' DFT products apply, over the F = Np / 2 +
    1 bins, made once per length and device. The irffts run unscaled
    (``norm="forward"``), so their 1 / Np is here, and the imaginary parts
    of DC and Nyquist, which an irfft does not read (:func:`_edge_mask`),
    are dropped before it and in its transpose: ``rows_t``, the row DFT's
    transpose (an irfft of the cotangents with DC and Nyquist doubled,
    times Np / 2); ``tail``, the irfft; ``tail_t``, its transpose (an rfft
    with the interior bins doubled, over Np)."""
    inner = _edge_mask(Np // 2 + 1, device)
    return {"rows_t": torch.stack([1.0 - 0.5 * inner, 0.5 * inner]),
            "tail": torch.stack([torch.ones_like(inner), inner]) / Np,
            "tail_t": torch.stack([1.0 + inner, 2.0 * inner]) / Np}


def _to_planes(z, width, F, w=None):
    """The real and imaginary parts of complex ``z`` [..., Fd], times ``w``
    [2, Fd] (real part, imaginary part) where given, in float32 rows of
    ``width`` >= Fd elements whose columns past Fd are zero, as [..., F]
    views (F <= width): the layout of a dense product against DFT
    matrices padded to ``width`` (pitched ones give pitched planes). Both
    planes are written by one copy into one allocation, the second plane
    at a 32-byte-aligned offset."""
    Fd = z.shape[-1]
    shape = (*z.shape[:-1], width)
    n = math.prod(shape)
    both = torch.empty((2, -(-n // 8) * 8), dtype=torch.float32,
                       device=z.device)[:, :n].view(2, *shape)
    both[..., Fd:].zero_()
    parts = torch.view_as_real(z).movedim(-1, 0)
    if w is None:
        both[..., :Fd].copy_(parts)
    else:
        torch.mul(parts, w.view(2, *([1] * (z.dim() - 1)), Fd),
                  out=both[..., :Fd])
    return both[0, ..., :F], both[1, ..., :F]


def _from_planes(re, im, w):
    """complex64 [..., Fd] from the first Fd columns of the real and
    imaginary planes ``re``/``im``, times ``w`` [2, Fd] (real part,
    imaginary part): the inverse of :func:`_to_planes`."""
    Fd = w.shape[-1]
    z = torch.empty((*re.shape[:-1], Fd), dtype=torch.complex64,
                    device=re.device)
    zr = torch.view_as_real(z)
    for i, x in enumerate((re, im)):
        torch.mul(x[..., :Fd], w[i], out=zr[..., i])
    return z


def _plane_spectra(imgs, t):
    """Forward DFT of both image orientations' rows, zero-padded to Np:
    [PB, N, N] -> ([PB, 2, N, F], [PB, 2, N, F]) real/imaginary planes, by
    a float32 real FFT along the rows, in the row pitch of ``Ere``/``Eim``
    (pitched ``fft_pallas`` tables: pitched spectra, pad columns zero;
    ``fft_mxu``'s: dense at their padded F, the columns past Np / 2 + 1
    zero)."""
    profiling.count("proj.fft")
    rows2 = torch.stack([imgs, imgs.transpose(1, 2)], dim=1)
    spec = torch.fft.rfft(rows2, n=_dft_len(t), dim=-1)
    return _to_planes(spec, padded(t["Ere"]).shape[-1], t["Ere"].shape[-1])


def _plane_spectra_t(rre2_bar, rim2_bar, t, dtype):
    """Exact transpose of :func:`_plane_spectra`: an irfft over Np with DC
    and Nyquist doubled and their imaginary parts dropped, times Np / 2,
    cut to the N pixels; then both orientations summed."""
    profiling.count("proj.fft")
    Np = _dft_len(t)
    X = _from_planes(rre2_bar, rim2_bar,
                     _dft_weights(Np, rre2_bar.device)["rows_t"])
    rows2_bar = torch.fft.irfft(X, n=Np, dim=-1, norm="forward")
    rows2_bar = rows2_bar[..., :rre2_bar.shape[2]]
    return (rows2_bar[:, 0] + rows2_bar[:, 1].transpose(1, 2)).to(dtype)


def _hat_on_the_fly(t) -> bool:
    """Whether the materialized hat weights w [PT, T, D, Np] would pass
    ``_HAT_MAX_BYTES``, so that the eval tail runs K17/K18."""
    PT, T, D = t["p"].shape
    return PT * T * D * t["Cre"].shape[-1] * 4 > _HAT_MAX_BYTES


def _hat_weights(t, dtype):
    """The materialized hat w[p, t, d, v] = max(0, 1 - |p[p,t,d] - v|)."""
    Np = t["Cre"].shape[-1]
    v_idx = torch.arange(Np, dtype=dtype, device=t["p"].device)
    return torch.clamp(1.0 - torch.abs(t["p"][..., None] - v_idx), min=0.0)


def _eval_tail(g_re, g_im, t, dtype):
    """irfft (float32, over Np) + hat evaluation + branch scale: [PB, T, F]
    spectra -> [PB, T, D] sinograms, through K17 past ``_HAT_MAX_BYTES``
    and the materialized hat weights below it."""
    profiling.count("proj.fft")
    PT = t["Cre"].shape[0]
    PB, T, _ = g_re.shape
    Np = _dft_len(t)
    G = _from_planes(g_re, g_im, _dft_weights(Np, g_re.device)["tail"])
    g = torch.fft.irfft(G, n=Np, dim=-1, norm="forward")  # [PB, T, Np]
    if _hat_on_the_fly(t):
        out = hat_eval(g, t["p"], t["s"].unsqueeze(-1))
        return out if dtype == torch.float32 else out.to(dtype)
    out = torch.einsum("ptdv,kptv->kptd", _hat_weights(t, dtype),
                       _kview(g, PT).to(dtype))
    return (t["s"][..., None] * out).reshape(PB, T, -1)


def _eval_tail_t(sinos, t):
    """Exact transpose of :func:`_eval_tail`: [PB, T, D] cotangents ->
    ([PB, T, F], [PB, T, F]) spectrum cotangents (a float32 rfft with the
    interior bins doubled, over Np, the imaginary parts of DC and Nyquist
    dropped), in the padded F of ``Cre``/``Cim`` (``fft_pallas``: pitched
    rows for K12, pad columns zero)."""
    profiling.count("proj.fft")
    PT = t["Cre"].shape[0]
    PB, T, _ = sinos.shape
    Np = _dft_len(t)
    if _hat_on_the_fly(t):
        g_bar = hat_eval_t(sinos.to(torch.float32).contiguous(), t["p"],
                           t["s"].unsqueeze(-1), Np)
    else:
        g_bar = torch.einsum("ptdv,kptd->kptv", _hat_weights(t, sinos.dtype),
                             t["s"][..., None] * _kview(sinos, PT))
    G = torch.fft.rfft(g_bar.reshape(PB, T, Np), dim=-1)
    return _to_planes(G, padded(t["Cre"], -2).shape[-2], t["Cre"].shape[1],
                      _dft_weights(Np, G.device)["tail_t"])


def project_nodes_merged(cfg: GeometryConfig, imgs: torch.Tensor,
                         tables: dict) -> torch.Tensor:
    """Batched forward projection [PB, N, N] -> [PB, T, D] on merged tables
    (:func:`precompute_merged_nodes`): row DFTs, the select filter-sum (K11)
    and the eval tail. Parallel beam only."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_pallas supports parallel beam only")
    t = tables
    rre2, rim2 = _plane_spectra(imgs, t)
    g_re, g_im = filter_sum_sel(rre2, rim2, t["Hre"], t["Him"], t["sel"])
    return _eval_tail(g_re, g_im, t, imgs.dtype)


def backproject_nodes_merged(cfg: GeometryConfig, sinos: torch.Tensor,
                             tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_merged`, composed by hand:
    eval-tail transpose, the select transpose (K12) and the row-DFT
    transpose."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_pallas supports parallel beam only")
    t = tables
    g_re_bar, g_im_bar = _eval_tail_t(sinos, t)
    rre2_bar, rim2_bar = filter_sum_sel_t(g_re_bar, g_im_bar, t["Hre"],
                                          t["Him"], t["sel"])
    return _plane_spectra_t(rre2_bar, rim2_bar, t, sinos.dtype)


def _slot_spectra(imgs, t):
    """Row spectra of the plane that each slot block reads: [PB, N, N] ->
    ([PB, TB, N, F], [PB, TB, N, F]), the one-hot gather of the plan's
    ``onehot`` [PT, TB, 2] (a torch einsum, an XLA einsum in JAX), over
    the padded width of the plane spectra: pitched (pad columns zero) for
    pitched ``fft_grouped`` tables, dense for ``fft_mxu``'s."""
    PT, TB = t["onehot"].shape[:2]
    PB, N = imgs.shape[:2]
    F = t["Ere"].shape[-1]
    rre2, rim2 = (padded(r) for r in _plane_spectra(imgs, t))
    return tuple(
        torch.einsum("kponf,pto->kptnf", _kview(r, PT), t["onehot"])
        .reshape(PB, TB, N, r.shape[-1]).contiguous()[..., :F]
        for r in (rre2, rim2)
    )


def _slot_spectra_t(rre_s_bar, rim_s_bar, t, dtype):
    """Exact transpose of :func:`_slot_spectra`."""
    PT = t["onehot"].shape[0]
    PB, _, N, F = rre_s_bar.shape
    rre2_bar, rim2_bar = (
        torch.einsum("kptnf,pto->kponf", _kview(r, PT), t["onehot"])
        .reshape(PB, 2, N, F)
        for r in (rre_s_bar, rim_s_bar)
    )
    return _plane_spectra_t(rre2_bar, rim2_bar, t, dtype)


def _slot_tail(g_re, g_im, t, dtype):
    """Slot unpermute of the [PB, Tp, F] spectra and the eval tail."""
    T = t["p"].shape[-2]
    g_re = filter_mxu.permute_rows(g_re, t["posfull"])[:, :T]
    g_im = filter_mxu.permute_rows(g_im, t["posfull"])[:, :T]
    return _eval_tail(g_re, g_im, t, dtype)


def _slot_tail_t(sinos, t):
    """Exact transpose of :func:`_slot_tail`: [PB, Tp, F] cotangents, in
    the padded F of ``Cre``/``Cim`` (pitched ``fft_grouped`` tables:
    pitched rows for K14; ``fft_mxu``'s: dense)."""
    F = t["Cre"].shape[1]
    return tuple(_pad_unpermute(padded(g), t).contiguous()[..., :F]
                 for g in _eval_tail_t(sinos, t))


def project_nodes_grouped(cfg: GeometryConfig, imgs: torch.Tensor,
                          tables: dict) -> torch.Tensor:
    """Batched forward projection [PB, N, N] -> [PB, T, D] on branch-grouped
    tables: row DFTs, the one-hot gather of each slot block's spectrum
    plane, the grouped filter-sum (K13), the slot unpermute and the hat
    evaluation."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_grouped supports parallel beam only")
    t = tables
    g_re, g_im = filter_sum_grouped(*_slot_spectra(imgs, t), t["Hre_g"],
                                    t["Him_g"])
    if "WCre" in t:
        out = _fold_tail(g_re, g_im, t)
        T = t["p"].shape[-2]
        return filter_mxu.permute_rows(out, t["posfull"])[:, :T].to(imgs.dtype)
    return _slot_tail(g_re, g_im, t, imgs.dtype)


def _wc(t: dict, key: str) -> torch.Tensor:
    """WC table ``key`` in float32 (a bf16 table's exact upcast)."""
    return t[key].to(torch.float32)


def _fold_tail(g_re, g_im, t):
    """The folded tail of ``fold_eval`` tables: [PB, Tp, F] slot spectra ->
    [PB, Tp, D], as the JAX package computes it: the spectra rounded to the
    WC dtype, then products summed in float32."""
    PT = t["WCre"].shape[0]
    wdt = t["WCre"].dtype
    out = sum(torch.einsum("ptdf,kptf->kptd", _wc(t, k),
                           _kview(g.to(wdt).to(torch.float32), PT))
              for k, g in (("WCre", g_re), ("WCim", g_im)))
    return out.reshape(g_re.shape[0], g_re.shape[1], -1)


def _fold_tail_t(sinos, t):
    """Exact transpose of :func:`_fold_tail` after the slot unpermute:
    [PB, T, D] cotangents -> the pitched [PB, Tp, F] pair K14 streams."""
    PT = t["WCre"].shape[0]
    wdt = t["WCre"].dtype
    ob = _kview(_pad_unpermute(sinos, t).to(wdt).to(torch.float32), PT)
    out = []
    for k in ("WCre", "WCim"):
        g = torch.einsum("ptdf,kptd->kptf", _wc(t, k), ob)
        g = g.reshape(sinos.shape[0], -1, g.shape[-1])
        out.append(pitched_zeros(g.shape, g.dtype, g.device).copy_(g))
    return out


def backproject_nodes_grouped(cfg: GeometryConfig, sinos: torch.Tensor,
                              tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_grouped`, composed by hand:
    hat-tail transpose, slot re-permute, the grouped transpose (K14), the
    transposed one-hot gather and the row-DFT transpose."""
    t = tables
    tail_t = _fold_tail_t if "WCre" in t else _slot_tail_t
    rre_s_bar, rim_s_bar = filter_sum_grouped_t(
        *tail_t(sinos, t), t["Hre_g"], t["Him_g"], t["onehot"].shape[1])
    return _slot_spectra_t(rre_s_bar, rim_s_bar, t, sinos.dtype)


def project_nodes_mxu(cfg: GeometryConfig, imgs: torch.Tensor,
                      tables: dict) -> torch.Tensor:
    """Batched forward projection [PB, N, N] -> [PB, T, D] on tiled tables
    (:func:`precompute_merged_mxu`): row DFTs, the one-hot gather of each
    slot block's spectrum plane, the tiled filter-sum (K15), the slot
    unpermute and the hat evaluation. Parallel beam only."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_mxu supports parallel beam only")
    t = tables
    g_re, g_im = filter_mxu.filter_sum_mxu(*_slot_spectra(imgs, t),
                                           t["Hre_t"], t["Him_t"])
    return _slot_tail(g_re, g_im, t, imgs.dtype)


def backproject_nodes_mxu(cfg: GeometryConfig, sinos: torch.Tensor,
                          tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_mxu`, composed by hand:
    hat-tail transpose, slot re-permute, the tiled transpose (K16), the
    transposed one-hot gather and the row-DFT transpose."""
    if cfg.fan_beam:
        raise NotImplementedError("fft_mxu supports parallel beam only")
    t = tables
    rre_s_bar, rim_s_bar = filter_mxu.filter_sum_mxu_t(
        *_slot_tail_t(sinos, t), t["Hre_t"], t["Him_t"],
        t["onehot"].shape[1])
    return _slot_spectra_t(rre_s_bar, rim_s_bar, t, sinos.dtype)


# ---------------------------------------------------------------------------
# fft: the split-table projector (no kernel)
# ---------------------------------------------------------------------------

# The filter sums below run over chunks of angles whose float32 products
# [K, PT, chunk, N, F] stay near this many bytes.
_CHUNK_BYTES = 2.56e8


def precompute_phases(cfg: GeometryConfig, angles: torch.Tensor,
                      valid: torch.Tensor | None = None,
                      table_dtype=torch.float32, dets=None) -> dict:
    """Tables of one node's :func:`project` (``angles``, ``valid`` [T]):
    each branch's shift-filter phases H [T, N, F] as real and imaginary
    planes in ``table_dtype`` (the rows of angles outside the branch, or
    not valid, zero, so the two branch outputs add), its recentred
    evaluation coordinates ``p_*`` [T, D] and its scale ``s_*`` [T]. The
    hat weights of the evaluation are rebuilt at each apply."""
    N = cfg.N
    Np = _padded_len(N, cfg.n_det)
    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = _coeffs(
        cfg, angles.to(torch.float32), dets)
    m_r = use_r.to(torch.float32)
    m_c = 1.0 - m_r
    if valid is not None:
        m_r = m_r * valid.to(torch.float32)
        m_c = m_c * valid.to(torch.float32)
    out = {}
    for b, (P_, B_, C_, s_, m) in (("r", (Pr, Br, Cr, sr, m_r)),
                                   ("c", (Pc, Bc, Cc, sc, m_c))):
        Hre, Him, delta = _branch_phases(P_, B_, C_, N, Np, m)
        out.update({f"Hre_{b}": Hre.to(table_dtype),
                    f"Him_{b}": Him.to(table_dtype),
                    f"p_{b}": P_ - delta[:, None], f"s_{b}": s_})
    return out


def precompute_phases_nodes(cfg: GeometryConfig, angles: torch.Tensor,
                            valid: torch.Tensor, table_dtype=torch.float32,
                            dets=None) -> dict:
    """Node-batched :func:`precompute_phases` (``angles``, ``valid``
    [P, T]): every leaf with the node count leading, as the JAX loader
    vmaps it; each node written into the batch as it is built."""
    return _node_batch(angles.shape[0], lambda i: precompute_phases(
        cfg, angles[i], valid[i], table_dtype, dets))


def _node_batch(P: int, build_one: Callable[[int], dict],
                pitched: bool = False) -> dict:
    """The node tables ``build_one(i)``, i < P, written into batch storage
    (:func:`_batch_storage`), so that no table is held twice."""
    out = {}
    for i in range(P):
        node = build_one(i)
        for k, v in node.items():
            if k not in out:
                out[k] = _batch_storage(k, (P, *v.shape), v, pitched)
            out[k][i] = v
        del node
    return out


def _chunk(per_angle_bytes: int) -> int:
    return max(1, int(_CHUNK_BYTES // max(per_angle_bytes, 1)))


def _edge_mask(F: int, device) -> torch.Tensor:
    """1 on the interior bins, 0 on DC and Nyquist: an irfft reads only the
    real part of those two, so their imaginary parts are dropped before it
    (where the FFT library may not ignore them) and in its transpose."""
    m = torch.ones(F, dtype=torch.float32, device=device)
    m[0] = 0.0
    m[-1] = 0.0
    return m


def _phase_sum(rhat: torch.Tensor, Hre: torch.Tensor, Him: torch.Tensor):
    """g[k, p, t, f] = sum_n rhat[k, p, n, f] H[p, t, n, f] in float32, as
    real and imaginary parts (the tables' exact upcast): [K, PT, N, F]
    row spectra against [PT, T, N, F] tables -> ([K, PT, T, F], same)."""
    K, PT, N, F = rhat.shape
    T = Hre.shape[1]
    rre, rim = rhat.real[:, :, None], rhat.imag[:, :, None]
    g_re = torch.empty((K, PT, T, F), dtype=torch.float32, device=rhat.device)
    g_im = torch.empty_like(g_re)
    step = _chunk(K * PT * N * F * 4)
    for t0 in range(0, T, step):
        hr = Hre[:, t0:t0 + step].to(torch.float32)
        hi = Him[:, t0:t0 + step].to(torch.float32)
        g_re[:, :, t0:t0 + step] = (rre * hr - rim * hi).sum(dim=3)
        g_im[:, :, t0:t0 + step] = (rre * hi + rim * hr).sum(dim=3)
    return g_re, g_im


def _phase_sum_t(g_re, g_im, Hre, Him):
    """Exact transpose of :func:`_phase_sum` with respect to the row
    spectra: ([K, PT, T, F], same) -> [K, PT, N, F] complex."""
    K, PT, T, F = g_re.shape
    N = Hre.shape[2]
    r_re = torch.zeros((K, PT, N, F), dtype=torch.float32,
                       device=g_re.device)
    r_im = torch.zeros_like(r_re)
    step = _chunk(K * PT * N * F * 4)
    for t0 in range(0, T, step):
        hr = Hre[:, t0:t0 + step].to(torch.float32)
        hi = Him[:, t0:t0 + step].to(torch.float32)
        gr = g_re[:, :, t0:t0 + step, None]
        gi = g_im[:, :, t0:t0 + step, None]
        r_re += (gr * hr + gi * hi).sum(dim=2)
        r_im += (gi * hr - gr * hi).sum(dim=2)
    return torch.complex(r_re, r_im)


def _hat(p: torch.Tensor, Np: int) -> torch.Tensor:
    """Materialized hat weights w[..., d, v] = max(0, 1 - |p[..., d] - v|),
    as the JAX package builds them."""
    v_idx = torch.arange(Np, dtype=torch.float32, device=p.device)
    return torch.clamp(1.0 - torch.abs(p[..., None] - v_idx), min=0.0)


def _branch_apply(rows: torch.Tensor, t: dict, b: str) -> torch.Tensor:
    """One branch on its image orientation: rows [K, PT, N, N] -> rFFT of
    the rows padded to Np -> the filter sum against ``Hre_b``/``Him_b``
    -> irFFT -> hat evaluation at ``p_b`` -> scale ``s_b``: [K, PT, T, D]."""
    Hre, Him = t[f"Hre_{b}"], t[f"Him_{b}"]
    F = Hre.shape[-1]
    Np = 2 * (F - 1)
    g_re, g_im = _phase_sum(torch.fft.rfft(rows, n=Np, dim=-1), Hre, Him)
    g = torch.fft.irfft(torch.complex(g_re, g_im * _edge_mask(F, rows.device)),
                        n=Np, dim=-1)  # [K, PT, T, Np]
    out = torch.einsum("ptdv,kptv->kptd", _hat(t[f"p_{b}"], Np), g)
    return t[f"s_{b}"][..., None] * out


def _branch_apply_t(ob: torch.Tensor, t: dict, b: str, N: int) -> torch.Tensor:
    """Exact transpose of :func:`_branch_apply`, composed by hand: the
    scale, the transposed hat contraction, the irFFT's transpose (an rFFT
    with the interior bins doubled, over Np), the transposed filter sum and
    the rFFT's transpose (an irFFT with DC and Nyquist doubled, times
    Np / 2, cut to the N pixels): [K, PT, T, D] -> [K, PT, N, N]."""
    Hre, Him = t[f"Hre_{b}"], t[f"Him_{b}"]
    F = Hre.shape[-1]
    Np = 2 * (F - 1)
    dev = ob.device
    g_bar = torch.einsum("ptdv,kptd->kptv", _hat(t[f"p_{b}"], Np),
                         t[f"s_{b}"][..., None] * ob)
    interior = _edge_mask(F, dev)
    G = torch.fft.rfft(g_bar, dim=-1) * ((1.0 + interior) / Np)
    r = _phase_sum_t(G.real, G.imag * interior, Hre, Him)
    edges = 2.0 - interior
    X = torch.complex(r.real * edges, r.imag * interior)
    return torch.fft.irfft(X, n=Np, dim=-1)[..., :N] * (Np / 2.0)


def project_nodes_phases(cfg: GeometryConfig, imgs: torch.Tensor,
                         tables: dict) -> torch.Tensor:
    """Mode ``fft``'s batched forward projection [PB, N, N] -> [PB, T, D]
    on :func:`precompute_phases_nodes` tables [PT, ...] (PB a multiple of
    PT, image p against table set p % PT): branch R on the rows, branch C
    on the transposed image, added. Torch FFTs and products, no kernel,
    as the JAX package's XLA path."""
    if cfg.fan_beam:
        raise NotImplementedError("FFT projector supports parallel beam only")
    t = tables
    PT = t["p_r"].shape[0]
    x = _kview(imgs, PT)
    out = _branch_apply(x, t, "r") + _branch_apply(x.transpose(-1, -2), t, "c")
    return out.reshape(imgs.shape[0], *out.shape[2:])


def backproject_nodes_phases(cfg: GeometryConfig, sinos: torch.Tensor,
                             tables: dict) -> torch.Tensor:
    """Exact adjoint of :func:`project_nodes_phases`, composed by hand."""
    t, N = tables, cfg.N
    PT = t["p_r"].shape[0]
    ob = _kview(sinos, PT)
    out = (_branch_apply_t(ob, t, "r", N)
           + _branch_apply_t(ob, t, "c", N).transpose(-1, -2))
    return out.reshape(sinos.shape[0], N, N)


def project(cfg: GeometryConfig, img: torch.Tensor, angles: torch.Tensor,
            valid: torch.Tensor | None = None,
            tables: dict | None = None) -> torch.Tensor:
    """One node's forward projection [N, N] x [T] -> [T, D] (the JAX
    package's signature); ``tables`` from :func:`precompute_phases` skip
    their build."""
    if tables is None:
        tables = precompute_phases(cfg, angles, valid)
    t = {k: v[None] for k, v in tables.items()}
    return project_nodes_phases(cfg, img[None], t)[0]


def backproject(cfg: GeometryConfig, sino: torch.Tensor, angles: torch.Tensor,
                valid: torch.Tensor | None = None,
                tables: dict | None = None) -> torch.Tensor:
    """Exact adjoint of :func:`project` [T, D] -> [N, N]."""
    if tables is None:
        tables = precompute_phases(cfg, angles, valid)
    t = {k: v[None] for k, v in tables.items()}
    return backproject_nodes_phases(cfg, sino[None], t)[0]


def colnorms_sq(cfg: GeometryConfig, angles: torch.Tensor,
                valid: torch.Tensor | None = None,
                block: int = 32) -> torch.Tensor:
    """Exact W[p] = ||A[:, p]||^2 of one node's operator [N, N], computed in
    the frequency domain.

    Squaring each ray's 2x2-tap weights and summing over detectors collapses
    the detector axis into two sequences G0, G1 indexed by the integer
    evaluation point; the pixel dependence is then a <= 2-tap circular read
    of them at the row shifts k = floor(sigma), i.e. a phase multiply:

        W_t[a, :] = irfft( G0^ ((1-fr)^2 e^{-iwk} + fr^2 e^{-iw(k+1)})
                           + G1^ 2 fr (1-fr) e^{-iwk} )(a)

    ``block`` angles are processed at a time."""
    if cfg.fan_beam:
        raise NotImplementedError("colnorms_sq: parallel beam only (fan "
                                  "beam: radon_fan.colnorms_sq)")
    dev = angles.device
    f32 = torch.float32
    N, D = cfg.N, cfg.n_det
    Np = _padded_len(N, D)
    F = Np // 2 + 1
    (Pr, Br, Cr, sr), (Pc, Bc, Cc, sc), use_r = _coeffs(cfg, angles.to(f32))
    T = angles.shape[0]
    vmask = torch.ones(T, dtype=f32, device=dev) if valid is None \
        else valid.to(f32)
    Pv = torch.where(use_r[:, None], Pr, Pc)  # [T, D]
    B = torch.where(use_r, Br, Bc)
    C = torch.where(use_r, Cr, Cc)
    sc_ = torch.where(use_r, sr, sc)

    a_idx = torch.arange(N, dtype=f32, device=dev)
    ang_f = (2.0 * math.pi / Np) * torch.arange(F, dtype=f32, device=dev)
    W = torch.zeros((N, N), dtype=f32, device=dev)
    for t0 in range(0, T, block):
        sl = slice(t0, min(T, t0 + block))
        Tc = sl.stop - sl.start
        pl_ = Pv[sl]  # [Tc, D]
        v0 = torch.remainder(torch.floor(pl_).long(), Np)
        v1 = torch.remainder(v0 + 1, Np)
        fp = pl_ - torch.floor(pl_)
        s2 = ((sc_[sl] * sc_[sl]) * vmask[sl])[:, None]
        G0 = torch.zeros((Tc, Np), dtype=f32, device=dev)
        G0.scatter_add_(1, v0, s2 * (1.0 - fp) ** 2)
        G0.scatter_add_(1, v1, s2 * fp * fp)
        G1 = torch.zeros((Tc, Np), dtype=f32, device=dev)
        G1.scatter_add_(1, v1, s2 * fp * (1.0 - fp))
        G0h = torch.fft.rfft(G0)[:, None, :]  # [Tc, 1, F]
        G1h = torch.fft.rfft(G1)[:, None, :]

        sig = B[sl, None] * a_idx + C[sl, None]  # [Tc, N]
        k = torch.floor(sig)
        fr = (sig - k)[..., None]
        ek = torch.polar(torch.ones((), dtype=f32, device=dev),
                         -(ang_f * k[..., None]))  # [Tc, N, F]
        e1 = torch.polar(torch.ones((), dtype=f32, device=dev), -ang_f) * ek
        What = G0h * ((1.0 - fr) ** 2 * ek + fr * fr * e1) \
            + G1h * ((2.0 * fr * (1.0 - fr)) * ek)
        Wt = torch.fft.irfft(What, n=Np, dim=-1)[..., :N]  # [Tc, a, i]
        Wt = torch.where(use_r[sl, None, None], Wt, Wt.transpose(1, 2))
        W += Wt.sum(dim=0)
    return W
