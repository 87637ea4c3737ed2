"""The nine kernels of the ``fft_skew`` and ``fft_shear`` projectors, with
their plain versions.

Each wrapper replaces one Pallas kernel of
``dip_admm_tpu/ops/pallas/shear_sum.py``:

====================== ============================================ ===================
wrapper                TPU kernel it replaces                       CUDA entry
====================== ============================================ ===================
skew_sum_planes        K1 skew_sum_planes (_skew_fwd_pallas_planes) dip_skew_fwd
skew_sum_planes_t      K2 skew_sum_planes_t (_skew_t_pallas_planes) dip_skew_t
eval_shear             K3 eval_shear (_eval_fwd_pallas)             dip_eval_fwd
eval_shear_t           K4 eval_shear_t (_eval_t_pallas)             dip_eval_t
skew_sum_planes_t_rows K6 skew_sum_planes_t_rows (row_width)        dip_skew_t
shear_sum_planes       K7 shear_sum_planes (_fwd_pallas_planes)     dip_shear_fwd
shear_sum_planes_t     K8 shear_sum_planes_t (_t_pallas_planes)     dip_shear_t
shear_sum              K9 shear_sum (_fwd_pallas)                   dip_shear_fwd
shear_sum_t            K10 shear_sum_t (_t_pallas)                  dip_shear_t
====================== ============================================ ===================

``fft_skew`` runs K1-K4, ``fft_shear`` K7, K8, K3 and K4 (its row stage on
the row spectra instead of the pixel rows, with the t-major taps ``Wt``).
Under pixel compute on a mesh (``parallel/admm_sharded.py``) ``fft_skew``
runs K1 on one shard's rows and K6 in place of K2: K2's kernel on the
shard's row blocks at the full row width. K9/K10 are K7/K8 on slot spectra
gathered one-hot per angle block [PB, TB, N, F] (K10 a pure map); no path
of the system runs them, only the stage phase of ``chip_smoke.py``.
On a CPU tensor a wrapper runs its plain PyTorch version (``*_ref``); on a
CUDA tensor it launches the hand-written kernel of ``csrc/shear_sum.cu`` or
raises. Both round to the table type at the JAX kernel's points (bf16
tables: image rows or row spectra before the tap product, the skew sum
before the DFT-back, the phase products of the transposes and of the eval
tail, PhiD, the pre-contracted eval cotangent); f32 tables round nowhere.

What bounds them on an H100, and what the simple design does about it:

- K1/K2 (skew stages) carry the projector's FLOPs: 2*P*Tp*D2*N*N for the
  dense tap product, ~14.5 GFLOP per direction at 256^2/8, of which only
  the two nonzero taps of D2 per row are needed. With f32 tables both are
  shared-memory tiled products on the CUDA cores with f32 accumulation
  (bound by shared-memory reads: 5 loads per 4 FMAs), two launches each
  (tap product, then DFT; or DFT, then tap product) through an f32 scratch
  of [P, TB, NB, tt, WZ]. With bf16 tables, the tables of every card path,
  both run their two products as bf16 mma.sync with f32 accumulators (the
  TPU kernel's MXU products) over the tap tiles that hold a nonzero,
  through one bf16 scratch sized by the library: K1 as two layout passes,
  the tap product and the DFT-back; K2 as a phase pass, the DFT-forward
  (zbar leaves it rounded to bf16 and transposed) and the tap product,
  which writes every element, so ``x2`` needs no memset. What bounds both
  now is the tap product's walk over its nonzero tiles (latency more than
  MMA throughput) and its per-stage marking of them; the source note in
  ``csrc/shear_sum.cu`` has the details. The TPU kernel's sequential
  accumulation axis becomes a loop inside the block that owns the output
  tile, so nothing relies on block order and nothing needs atomics.
- K3/K4 (eval tail) are small products (~0.6 GFLOP) beside a large, 99%
  zero table Wd (75.5 MB in bf16 at 256^2/8), so their bytes bound them.
  The JAX package runs the Wd epilogue and pre-contraction as XLA einsums
  outside Pallas; here each wrapper is two hand-written launches with no
  torch op between: K3 the R stage (bf16 mma.sync with bf16 tables, PhiD
  read in f32 and rounded in the block), then one stream over the dense Wd
  in its own type; K4 that stream first (Rbar rounded to the table type),
  then the phase products (bf16 mma.sync) and the phase combine. The
  source note in ``csrc/shear_sum.cu`` has the details.
- K7/K8 (shear stages): the TPU kernel's dense tap product on the row
  spectra is 4*P*Tp*D2*nb*NB*F FLOPs (~58 GFLOP per direction at
  256^2/8), but only two of a row's D2 taps are nonzero (~0.8 GFLOP
  needed), so the least time of the function is that of its bytes. With
  f32 tables both run that dense product register-tiled on the CUDA
  cores, one launch each. With bf16 tables each is two launches through a
  scratch that the library sizes: a mask pass that reads the tap table
  once and marks its nonzero 8 x 8 tiles, then bf16 mma.sync over the
  marked tiles only (K7: spectra as the A fragments in registers; K8: S
  formed in registers as the A fragments), each step's tiles shared by
  four warps through a cp.async ring. K7's block owns its output tile and
  adds the row blocks in order; K8's owns one (image, plane, row block)
  tile, adds the angle blocks on that plane in order, and writes every
  element, zeros for a plane no angle block reads. The source note in
  ``csrc/shear_sum.cu`` has the details.

Node-shared tables: every wrapper takes an image batch PB and a table batch
PT that divides it (the leading dims of the image-side and table-side
arguments); image p reads table set p % PT, the rule of the JAX kernels'
vmap, which folds an image batch into the node axis and keeps one table
set. The parallel paths run PT = PB; the fan-beam path runs its PB = P node
images against the one shared parallel-stage table set (PT = 1).

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (one per
call that launches, none for the plain version); ``launch_counts`` and
``reset_launch_counts`` read and clear them.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build


def _rnd(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """Round f32 to bf16 precision when the tables are bf16."""
    return x.to(torch.bfloat16).float() if lowp else x


def _per_image(PB: int, *tables):
    """Tables [PT, ...] tiled to [PB, ...], so that image p reads table set
    p % PT (the plain versions' form of the node-shared table batch)."""
    out = []
    for t in tables:
        PT = t.shape[0]
        _batches("plain version", PB, PT)
        out.append(t if PT == PB else t.repeat(PB // PT, *[1] * (t.dim() - 1)))
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def skew_sum_planes_ref(rows2, WtT, SEre, SEim, Dre, Dim, plane):
    """Spatial skew row stage forward: two-plane image rows [PB, 2, N, WS]
    -> slot-order spectrum pair [PB, Tp, F], on tables of batch PT.

    Per (image p, angle block tb, row block b) on plane ``plane[p, tb]``:
    sigma[d,t,u] = sum_n WtT[d,t,n] x[n,u]; z[t,(D2-1-d)+u] += sigma[d,t,u];
    g += E_b * (z @ D), summed over the row blocks."""
    WtT, SEre, SEim, plane = _per_image(rows2.shape[0], WtT, SEre, SEim, plane)
    P, NB, D2, Tp, nb = WtT.shape
    WS = rows2.shape[-1]
    WZ, F = Dre.shape
    TB = plane.shape[1]
    tt = Tp // TB
    lowp = WtT.dtype == torch.bfloat16
    pidx = torch.arange(P, device=rows2.device)[:, None]
    x = rows2[pidx, plane.long()].reshape(P, TB, NB, nb, WS)
    x = _rnd(x.float(), lowp)
    W = WtT.float().reshape(P, NB, D2, TB, tt, nb)
    sig = torch.einsum("pbdktn,pkbnu->pkbdtu", W, x)  # [P,TB,NB,D2,tt,WS]
    z = torch.zeros((P, TB, NB, tt, WZ), dtype=torch.float32,
                    device=rows2.device)
    for d in range(D2):
        off = D2 - 1 - d
        z[..., off:off + WS] += sig[:, :, :, d]
    z = _rnd(z, Dre.dtype == torch.bfloat16)
    Zr = z @ Dre.float()  # [P,TB,NB,tt,F]
    Zi = z @ Dim.float()
    ere = SEre.reshape(P, NB, TB, tt, F).transpose(1, 2)
    eim = SEim.reshape(P, NB, TB, tt, F).transpose(1, 2)
    gre = (Zr * ere - Zi * eim).sum(dim=2).reshape(P, Tp, F)
    gim = (Zr * eim + Zi * ere).sum(dim=2).reshape(P, Tp, F)
    return gre, gim


def skew_sum_planes_t_ref(gre_b, gim_b, WtT, SEre, SEim, DreT, DimT, plane):
    """Exact transpose of :func:`skew_sum_planes_ref`: [PB, Tp, F] pair ->
    row cotangents of both planes [PB, 2, N, N]. Planes that no angle block
    reads come out zero (the JAX kernel leaves them uninitialized and
    masks them with ``pvisited`` afterwards)."""
    return skew_sum_planes_t_rows_ref(gre_b, gim_b, WtT, SEre, SEim, DreT,
                                      DimT, plane, WtT.shape[1] * WtT.shape[-1])


def skew_sum_planes_t_rows_ref(gre_b, gim_b, WtT, SEre, SEim, DreT, DimT,
                               plane, row_width):
    """:func:`skew_sum_planes_t_ref` on the NB row blocks that ``WtT`` and
    ``SE*`` carry (one pixel shard's, under row sharding) at the full row
    width ``row_width``: [PB, Tp, F] pair -> [PB, 2, NB * nb, row_width]."""
    WtT, SEre, SEim, plane = _per_image(gre_b.shape[0], WtT, SEre, SEim, plane)
    P, NB, D2, Tp, nb = WtT.shape
    F, WZ = DreT.shape
    TB = plane.shape[1]
    tt = Tp // TB
    WS = row_width
    lowp = WtT.dtype == torch.bfloat16
    g_r = gre_b.reshape(P, TB, 1, tt, F)
    g_i = gim_b.reshape(P, TB, 1, tt, F)
    ere = SEre.reshape(P, NB, TB, tt, F).transpose(1, 2)
    eim = SEim.reshape(P, NB, TB, tt, F).transpose(1, 2)
    dlowp = DreT.dtype == torch.bfloat16
    Zr = _rnd(g_r * ere + g_i * eim, dlowp)  # conj(E) * g_bar
    Zi = _rnd(g_i * ere - g_r * eim, dlowp)
    zbar = Zr @ DreT.float() + Zi @ DimT.float()  # [P,TB,NB,tt,WZ]
    win = torch.stack(
        [zbar[..., D2 - 1 - d:D2 - 1 - d + WS] for d in range(D2)], dim=3
    )  # [P,TB,NB,D2,tt,WS]
    win = _rnd(win, lowp)
    W = WtT.float().reshape(P, NB, D2, TB, tt, nb)
    part = torch.einsum("pbdktn,pkbdtu->pkbnu", W, win)  # [P,TB,NB,nb,WS]
    x2 = torch.zeros((P * 2, NB, nb, WS), dtype=torch.float32,
                     device=gre_b.device)
    dst = (torch.arange(P, device=plane.device)[:, None] * 2
           + plane.long()).reshape(-1)
    x2.index_add_(0, dst, part.reshape(P * TB, NB, nb, WS))
    return x2.reshape(P, 2, NB * nb, WS)


def shear_sum_planes_ref(rre2, rim2, Wt, SEre, SEim, Phire, Phiim, plane):
    """Spectral shear row stage forward: two-plane row spectra [PB, 2, N, F]
    pair -> slot-order spectrum pair [PB, Tp, F], on tables of batch PT.

    Per (image p, angle block tb, row block b) on plane ``plane[p, tb]``:
    S[t,d,f] = sum_n Wt[t,d,n] r[n,f] (r rounded to bf16 with bf16 taps);
    g += E_b * sum_d Phi[d,f] S[t,d,f], summed over the row blocks."""
    plane = _per_image(rre2.shape[0], plane)[0]
    pidx = torch.arange(rre2.shape[0], device=rre2.device)[:, None]
    return shear_sum_ref(rre2[pidx, plane.long()], rim2[pidx, plane.long()],
                         Wt, SEre, SEim, Phire, Phiim)


def shear_sum_ref(rre_s, rim_s, Wt, SEre, SEim, Phire, Phiim):
    """K7 on slot spectra already gathered per angle block: [PB, TB, N, F]
    pair -> [PB, Tp, F] pair; angle block tb reads ``rre_s[:, tb]``."""
    Wt, SEre, SEim = _per_image(rre_s.shape[0], Wt, SEre, SEim)
    P, NB, Tp, D2, nb = Wt.shape
    TB, F = rre_s.shape[1], rre_s.shape[-1]
    tt = Tp // TB
    lowp = Wt.dtype == torch.bfloat16
    xr, xi = (_rnd(r.float(), lowp).reshape(P, TB, NB, nb, F)
              for r in (rre_s, rim_s))
    W = Wt.float().reshape(P, NB, TB, tt, D2, nb)
    Sre = torch.einsum("pbktdn,pkbnf->pbktdf", W, xr)  # [P,NB,TB,tt,D2,F]
    Sim = torch.einsum("pbktdn,pkbnf->pbktdf", W, xi)
    phr, phi = Phire.float(), Phiim.float()
    Tre = (Sre * phr - Sim * phi).sum(dim=4)  # [P, NB, TB, tt, F]
    Tim = (Sre * phi + Sim * phr).sum(dim=4)
    del Sre, Sim
    ere = SEre.reshape(P, NB, TB, tt, F)
    eim = SEim.reshape(P, NB, TB, tt, F)
    gre = (Tre * ere - Tim * eim).sum(dim=1).reshape(P, Tp, F)
    gim = (Tre * eim + Tim * ere).sum(dim=1).reshape(P, Tp, F)
    return gre, gim


def shear_sum_planes_t_ref(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim,
                           plane):
    """Exact transpose of :func:`shear_sum_planes_ref` with respect to the
    (rounded) spectra: [PB, Tp, F] pair -> [PB, 2, N, F] pair. S =
    conj(Phi) conj(E) g_bar is formed in f32 in the JAX kernel's order and
    rounded to bf16 with bf16 taps. A plane that no angle block reads comes
    out zero (the JAX kernel leaves it undefined and masks it with
    ``pvisited`` afterwards)."""
    plane = _per_image(gre_b.shape[0], plane)[0]
    P, TB = plane.shape
    dst = (torch.arange(P, device=plane.device)[:, None] * 2
           + plane.long()).reshape(-1)
    out = []
    for part in shear_sum_t_ref(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim,
                                TB):
        x2 = torch.zeros((P * 2,) + part.shape[2:], dtype=torch.float32,
                         device=gre_b.device)
        x2.index_add_(0, dst, part.reshape((P * TB,) + part.shape[2:]))
        out.append(x2.reshape((P, 2) + part.shape[2:]))
    return out[0], out[1]


def shear_sum_t_ref(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim, TB: int):
    """Exact transpose of :func:`shear_sum_ref`, a pure map: [PB, Tp, F]
    pair -> [PB, TB, N, F] pair, angle block tb's cotangent in slot tb."""
    Wt, SEre, SEim = _per_image(gre_b.shape[0], Wt, SEre, SEim)
    P, NB, Tp, D2, nb = Wt.shape
    F = gre_b.shape[-1]
    tt = Tp // TB
    lowp = Wt.dtype == torch.bfloat16
    g_r = gre_b.reshape(P, 1, TB, tt, 1, F)
    g_i = gim_b.reshape(P, 1, TB, tt, 1, F)
    ere = SEre.reshape(P, NB, TB, tt, 1, F)
    eim = SEim.reshape(P, NB, TB, tt, 1, F)
    Tre = g_r * ere + g_i * eim  # conj(E) * g_bar
    Tim = g_i * ere - g_r * eim
    phr, phi = Phire.float(), Phiim.float()
    Sre = _rnd(Tre * phr + Tim * phi, lowp)  # conj(Phi): [P,NB,TB,tt,D2,F]
    Sim = _rnd(Tim * phr - Tre * phi, lowp)
    del Tre, Tim
    W = Wt.float().reshape(P, NB, TB, tt, D2, nb)
    return tuple(torch.einsum("pbktdn,pbktdf->pkbnf", W, S).reshape(
        P, TB, NB * nb, F) for S in (Sre, Sim))


def _eval_epilogue(R, Wd):
    """out[p,t,b*db+d] = sum_z R[p,b,t,z] Wd[p%PT,b,t,z,d] (f32 x upcast
    Wd), R [PB, DB, Tp, D2p]."""
    PT, DB, Tp, D2p, db = Wd.shape
    PB = R.shape[0]
    out = torch.einsum("kpbtz,pbtzd->kptbd",
                       R.reshape(PB // PT, PT, DB, Tp, D2p), Wd.float())
    return out.reshape(PB, Tp, DB * db)


def _eval_t_prologue(ob, Wd):
    """Rbar[p,b,t,z] = sum_d ob[p,t,b*db+d] Wd[p%PT,b,t,z,d]."""
    PT, DB, Tp, D2p, db = Wd.shape
    PB = ob.shape[0]
    Rbar = torch.einsum("kptbd,pbtzd->kpbtz",
                        ob.reshape(PB // PT, PT, Tp, DB, db), Wd.float())
    return Rbar.reshape(PB, DB, Tp, D2p).contiguous()


def _eval_r_ref(gre, gim, TEre, TEim, PhiDre, PhiDim, lowp):
    TEre, TEim = _per_image(gre.shape[0], TEre, TEim)
    A = _rnd(gre[:, None] * TEre - gim[:, None] * TEim, lowp)
    B = _rnd(gre[:, None] * TEim + gim[:, None] * TEre, lowp)
    return A @ PhiDre.float().T - B @ PhiDim.float().T  # [P,DB,Tp,D2p]


def eval_shear_ref(gre, gim, Wd, TEre, TEim, PhiDre, PhiDim):
    """Factored hat-evaluation tail: slot-order spectra [PB, Tp, F] pair ->
    slot-order sinograms [PB, Tp, D] (branch scale and row masks are folded
    into Wd). PhiD is cast to Wd's dtype, as the JAX kernel's caller does."""
    lowp = Wd.dtype == torch.bfloat16
    R = _eval_r_ref(gre, gim, TEre, TEim, PhiDre.to(Wd.dtype),
                    PhiDim.to(Wd.dtype), lowp)
    return _eval_epilogue(R, Wd)


def eval_shear_t_ref(ob, Wd, TEre, TEim, PhiDre, PhiDim):
    """Exact transpose of :func:`eval_shear_ref`."""
    lowp = Wd.dtype == torch.bfloat16
    Rbar = _rnd(_eval_t_prologue(ob, Wd), lowp)
    phr = PhiDre.to(Wd.dtype).float()
    phi = PhiDim.to(Wd.dtype).float()
    TEre, TEim = _per_image(ob.shape[0], TEre, TEim)
    A = Rbar @ phr  # [P,DB,Tp,F]
    B = -(Rbar @ phi)
    gre = (A * TEre + B * TEim).sum(dim=1)
    gim = (-A * TEim + B * TEre).sum(dim=1)
    return gre, gim


# ---------------------------------------------------------------------------
# Launch helpers
# ---------------------------------------------------------------------------


def _stream() -> int:
    """The current CUDA stream of the current device, as an int. The raw
    query skips the ``torch.cuda.Stream`` object that ``current_stream()``
    builds (about 6 us of host time per launch on an H100 host)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _check(name: str, tensors: dict, device, table_dtype, strided=()):
    """Device, type and contiguity of a kernel's tensors; those named in
    ``strided`` are exempt from contiguity (their caller checks their
    strides)."""
    if table_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported table dtype {table_dtype}")
    for k, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {device}")
        if k not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    for k, t in tensors.items():
        if k == "plane":
            if t.dtype != torch.int32:
                raise TypeError(f"{name}: {k} must be int32, got {t.dtype}")
        elif k in ("WtT", "Wt", "Dre", "Dim", "DreT", "DimT", "Wd", "Hre",
                   "Him", "Hre_g", "Him_g", "Hre_t", "Him_t"):
            if t.dtype != table_dtype:
                raise TypeError(
                    f"{name}: {k} is {t.dtype}, the tables are {table_dtype}"
                )
        elif t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")


def _shape(name, t, shape, what):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:  # the card's path first: it costs one attribute read
        return False
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _batches(name: str, PB: int, PT: int) -> None:
    if PT < 1 or PB % PT:
        raise ValueError(f"{name}: image batch {PB} is not a multiple of the "
                         f"table batch {PT}")


def skew_sum_planes(rows2, WtT, SEre, SEim, Dre, Dim, plane):
    """K1: see :func:`skew_sum_planes_ref`."""
    if _on_cpu(rows2):
        return skew_sum_planes_ref(rows2, WtT, SEre, SEim, Dre, Dim, plane)
    name = "skew_sum_planes"
    PT, NB, D2, Tp, nb = WtT.shape
    PB = rows2.shape[0]
    WZ, F = Dre.shape
    TB = plane.shape[1]
    WS = rows2.shape[-1]
    _check(name, dict(rows2=rows2, WtT=WtT, SEre=SEre, SEim=SEim, Dre=Dre,
                      Dim=Dim, plane=plane), rows2.device, WtT.dtype)
    _batches(name, PB, PT)
    _shape(name, rows2, (PB, 2, NB * nb, WS), "rows2")
    _shape(name, SEre, (PT, NB, Tp, F), "SEre")
    _shape(name, SEim, (PT, NB, Tp, F), "SEim")
    _shape(name, Dim, (WZ, F), "Dim")
    _shape(name, plane, (PT, TB), "plane")
    if Tp % TB or WS + D2 - 1 > WZ:
        raise ValueError(f"{name}: inconsistent Tp={Tp}, TB={TB}, WS={WS}, "
                         f"D2={D2}, WZ={WZ}")
    tt = Tp // TB
    dev = rows2.device
    lib = _build.load("shear_sum")
    # The kernel's scratch: with f32 tables the skew sum z in f32; with
    # bf16 tables one bf16 buffer for z, the rounded rows and D in the
    # tensor-core kernels' layouts, sized by the library.
    if WtT.dtype == torch.bfloat16:
        n = lib.dip_skew_fwd_scratch(PB, TB, NB, tt, nb, D2, WS, F)
        z = torch.empty(n, dtype=torch.bfloat16, device=dev)
    else:
        z = torch.empty((PB, TB, NB, tt, WZ), dtype=torch.float32, device=dev)
    gre = torch.empty((PB, Tp, F), dtype=torch.float32, device=dev)
    gim = torch.empty_like(gre)
    rc = lib.dip_skew_fwd(
        *(t.data_ptr() for t in (
            rows2, WtT, SEre, SEim, Dre, Dim, plane, z, gre, gim)),
        PB, PT, NB, D2, Tp, nb, TB, WS, WZ, F,
        int(WtT.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    skew_sum_planes.launches += 1
    return gre, gim


def skew_sum_planes_t(gre_b, gim_b, WtT, SEre, SEim, DreT, DimT, plane):
    """K2: see :func:`skew_sum_planes_t_ref`."""
    if _on_cpu(gre_b):
        return skew_sum_planes_t_ref(gre_b, gim_b, WtT, SEre, SEim, DreT,
                                     DimT, plane)
    x2 = _skew_t_launch("skew_sum_planes_t", gre_b, gim_b, WtT, SEre, SEim,
                        DreT, DimT, plane, WtT.shape[1] * WtT.shape[-1])
    skew_sum_planes_t.launches += 1
    return x2


def skew_sum_planes_t_rows(gre_b, gim_b, WtT, SEre, SEim, DreT, DimT, plane,
                           row_width):
    """K6: see :func:`skew_sum_planes_t_rows_ref`. K2's kernel at the full
    row width ``row_width`` on the row blocks that ``WtT``/``SE*`` carry."""
    if _on_cpu(gre_b):
        return skew_sum_planes_t_rows_ref(gre_b, gim_b, WtT, SEre, SEim, DreT,
                                          DimT, plane, row_width)
    x2 = _skew_t_launch("skew_sum_planes_t_rows", gre_b, gim_b, WtT, SEre,
                        SEim, DreT, DimT, plane, row_width)
    skew_sum_planes_t_rows.launches += 1
    return x2


def _skew_t_launch(name, gre_b, gim_b, WtT, SEre, SEim, DreT, DimT, plane,
                   WS):
    """Checks and launch of ``dip_skew_t`` (K2, and K6 at WS > NB * nb)."""
    PT, NB, D2, Tp, nb = WtT.shape
    PB = gre_b.shape[0]
    F, WZ = DreT.shape
    TB = plane.shape[1]
    _check(name, dict(gre_b=gre_b, gim_b=gim_b, WtT=WtT, SEre=SEre,
                      SEim=SEim, DreT=DreT, DimT=DimT, plane=plane),
           gre_b.device, WtT.dtype)
    _batches(name, PB, PT)
    _shape(name, gre_b, (PB, Tp, F), "gre_b")
    _shape(name, gim_b, (PB, Tp, F), "gim_b")
    _shape(name, SEre, (PT, NB, Tp, F), "SEre")
    _shape(name, SEim, (PT, NB, Tp, F), "SEim")
    _shape(name, DimT, (F, WZ), "DimT")
    _shape(name, plane, (PT, TB), "plane")
    if Tp % TB or WS + D2 - 1 > WZ:
        raise ValueError(f"{name}: inconsistent Tp={Tp}, TB={TB}, WS={WS}, "
                         f"D2={D2}, WZ={WZ}")
    tt = Tp // TB
    C8 = -(-tt // 8)
    if WtT.dtype == torch.bfloat16 and (WZ % 8 or C8 > 8 or TB > 64 or (
            D2 * C8 + 128) * C8 >= 65536):
        raise ValueError(f"{name}: the bf16 kernels take WZ % 8 == 0, at "
                         f"most 64 slots and 64 angle blocks, and "
                         f"(D2 * C8 + 128) * C8 < 65536 for C8 = ceil(tt / 8) "
                         f"(WZ={WZ}, tt={tt}, TB={TB}, D2={D2})")
    dev = gre_b.device
    lib = _build.load("shear_sum")
    # The kernel's scratch: with f32 tables zbar in f32; with bf16 tables
    # one bf16 buffer for the phased cotangent and zbar in the tensor-core
    # kernels' layouts, sized by the library.
    if WtT.dtype == torch.bfloat16:
        n = lib.dip_skew_t_scratch(PB, TB, NB, tt, D2, WS, F)
        zbar = torch.empty(n, dtype=torch.bfloat16, device=dev)
    else:
        zbar = torch.empty((PB, TB, NB, tt, WZ), dtype=torch.float32,
                           device=dev)
    # The kernels write every element, zeros where no angle block reads a
    # plane (the JAX kernel leaves such a plane uninitialized).
    x2 = torch.empty((PB, 2, NB * nb, WS), dtype=torch.float32, device=dev)
    rc = lib.dip_skew_t(
        *(t.data_ptr() for t in (
            gre_b, gim_b, WtT, SEre, SEim, DreT, DimT, plane, zbar, x2)),
        PB, PT, NB, D2, Tp, nb, TB, WS, WZ, F,
        int(WtT.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    return x2


def _check_shear(name, spectra, Wt, SEre, SEim, Phire, Phiim, plane=None,
                 TB=None):
    """Checks of K7-K10's arguments; returns (PB, PT, NB, Tp, D2, nb, TB,
    F). ``spectra``: the image-side pair by name; K7/K8 pass ``plane``,
    K9/K10 the angle-block count ``TB``."""
    first = next(iter(spectra.values()))
    tensors = dict(**spectra, Wt=Wt, SEre=SEre, SEim=SEim, Phire=Phire,
                   Phiim=Phiim)
    if plane is not None:
        tensors["plane"] = plane
    _check(name, tensors, first.device, Wt.dtype)
    PT, NB, Tp, D2, nb = Wt.shape
    PB, F = first.shape[0], first.shape[-1]
    TB = plane.shape[1] if plane is not None else TB
    _batches(name, PB, PT)
    _shape(name, SEre, (PT, NB, Tp, F), "SEre")
    _shape(name, SEim, (PT, NB, Tp, F), "SEim")
    _shape(name, Phire, (D2, F), "Phire")
    _shape(name, Phiim, (D2, F), "Phiim")
    if plane is not None:
        _shape(name, plane, (PT, TB), "plane")
    if TB < 1 or Tp % TB:
        raise ValueError(f"{name}: Tp={Tp} is not a multiple of TB={TB}")
    if Wt.dtype == torch.bfloat16 and (
            nb % 8 or nb > 128 or D2 % 16 or D2 > 256 or Tp > 4096 or
            NB > 128 or Wt.data_ptr() % 16 or Wt.numel() >= 2**31):
        raise ValueError(f"{name}: the bf16 kernels take nb % 8 == 0, "
                         f"nb <= 128, D2 % 16 == 0, D2 <= 256, Tp <= 4096, "
                         f"NB <= 128 and Wt 16-byte aligned with fewer than "
                         f"2^31 elements (nb={nb}, D2={D2}, Tp={Tp}, NB={NB})")
    return PB, PT, NB, Tp, D2, nb, TB, F


def _shear_launch(entry, name, a, b, Wt, SEre, SEim, Phire, Phiim, plane,
                  out_shape, dims):
    """Launch ``dip_shear_fwd`` or ``dip_shear_t`` (``entry``) on the pair
    (a, b) into a new [out_shape] pair; ``plane`` None for K9/K10; ``dims``
    as ``_check_shear`` returns them. With bf16 tables the library's
    scratch holds the tap-tile mask."""
    PB, PT, NB, Tp, D2, nb, TB, F = dims
    dev = a.device
    lib = _build.load("shear_sum")
    bf16 = Wt.dtype == torch.bfloat16
    scratch = (torch.empty(lib.dip_shear_scratch(PT, NB, Tp, D2),
                           dtype=torch.int32, device=dev) if bf16 else None)
    o_re = torch.empty(out_shape, dtype=torch.float32, device=dev)
    o_im = torch.empty_like(o_re)
    rc = getattr(lib, entry)(
        *(t.data_ptr() for t in (a, b, Wt, SEre, SEim, Phire, Phiim)),
        None if plane is None else plane.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        o_re.data_ptr(), o_im.data_ptr(),
        PB, PT, NB, Tp, D2, nb, TB, F, int(bf16), _stream(),
    )
    _raise_if(rc, name)
    return o_re, o_im


def shear_sum_planes(rre2, rim2, Wt, SEre, SEim, Phire, Phiim, plane):
    """K7: see :func:`shear_sum_planes_ref`."""
    if _on_cpu(rre2):
        return shear_sum_planes_ref(rre2, rim2, Wt, SEre, SEim, Phire, Phiim,
                                    plane)
    name = "shear_sum_planes"
    dims = _check_shear(name, dict(rre2=rre2, rim2=rim2), Wt, SEre, SEim,
                        Phire, Phiim, plane)
    PB, _, NB, Tp, _, nb, _, F = dims
    _shape(name, rre2, (PB, 2, NB * nb, F), "rre2")
    _shape(name, rim2, (PB, 2, NB * nb, F), "rim2")
    out = _shear_launch("dip_shear_fwd", name, rre2, rim2, Wt, SEre, SEim,
                        Phire, Phiim, plane, (PB, Tp, F), dims)
    shear_sum_planes.launches += 1
    return out


def shear_sum_planes_t(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim, plane):
    """K8: see :func:`shear_sum_planes_t_ref`. The kernel writes every
    element of both planes, zeros where no angle block reads a plane."""
    if _on_cpu(gre_b):
        return shear_sum_planes_t_ref(gre_b, gim_b, Wt, SEre, SEim, Phire,
                                      Phiim, plane)
    name = "shear_sum_planes_t"
    dims = _check_shear(name, dict(gre_b=gre_b, gim_b=gim_b), Wt, SEre,
                        SEim, Phire, Phiim, plane)
    PB, _, NB, Tp, _, nb, _, F = dims
    _shape(name, gre_b, (PB, Tp, F), "gre_b")
    _shape(name, gim_b, (PB, Tp, F), "gim_b")
    out = _shear_launch("dip_shear_t", name, gre_b, gim_b, Wt, SEre, SEim,
                        Phire, Phiim, plane, (PB, 2, NB * nb, F), dims)
    shear_sum_planes_t.launches += 1
    return out


def shear_sum(rre_s, rim_s, Wt, SEre, SEim, Phire, Phiim):
    """K9: see :func:`shear_sum_ref`. K7's kernel with angle block tb
    reading slot tb of the gathered spectra instead of a plane."""
    if _on_cpu(rre_s):
        return shear_sum_ref(rre_s, rim_s, Wt, SEre, SEim, Phire, Phiim)
    name = "shear_sum"
    dims = _check_shear(name, dict(rre_s=rre_s, rim_s=rim_s), Wt, SEre,
                        SEim, Phire, Phiim, TB=rre_s.shape[1])
    PB, _, NB, Tp, _, nb, TB, F = dims
    _shape(name, rre_s, (PB, TB, NB * nb, F), "rre_s")
    _shape(name, rim_s, (PB, TB, NB * nb, F), "rim_s")
    # no plane table: angle block tb reads slot tb
    out = _shear_launch("dip_shear_fwd", name, rre_s, rim_s, Wt, SEre, SEim,
                        Phire, Phiim, None, (PB, Tp, F), dims)
    shear_sum.launches += 1
    return out


def shear_sum_t(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim, TB: int):
    """K10: see :func:`shear_sum_t_ref`. K8's kernel as a pure map: each
    block writes slot tb of its row block from angle block tb alone."""
    if _on_cpu(gre_b):
        return shear_sum_t_ref(gre_b, gim_b, Wt, SEre, SEim, Phire, Phiim,
                               TB)
    name = "shear_sum_t"
    dims = _check_shear(name, dict(gre_b=gre_b, gim_b=gim_b), Wt, SEre,
                        SEim, Phire, Phiim, TB=TB)
    PB, _, NB, Tp, _, nb, _, F = dims
    _shape(name, gre_b, (PB, Tp, F), "gre_b")
    _shape(name, gim_b, (PB, Tp, F), "gim_b")
    # no plane table: slot tb from angle block tb
    out = _shear_launch("dip_shear_t", name, gre_b, gim_b, Wt, SEre, SEim,
                        Phire, Phiim, None, (PB, TB, NB * nb, F), dims)
    shear_sum_t.launches += 1
    return out


def _eval_checks(name, tensors, Wd, PB, F, aligned=("Wd",)):
    """Checks of K3/K4's arguments (``tensors`` by name, Wd among them):
    PhiD in f32, the kernel rounds it; the tensors named in ``aligned``,
    which the Wd streams read with 16-byte loads, start 16-byte aligned.
    Returns (PT, DB, Tp, D2p, db)."""
    _check(name, tensors, Wd.device, Wd.dtype)
    PT, DB, Tp, D2p, db = Wd.shape
    _batches(name, PB, PT)
    for k in ("TEre", "TEim"):
        _shape(name, tensors[k], (PT, DB, Tp, F), k)
    for k in ("PhiDre", "PhiDim"):
        _shape(name, tensors[k], (D2p, F), k)
    if D2p % 16:
        raise ValueError(f"{name}: the kernels take D2p % 16 == 0 "
                         f"(D2p={D2p})")
    for k in aligned:
        if tensors[k].data_ptr() % 16:
            raise ValueError(f"{name}: {k} must start 16-byte aligned")
    return PT, DB, Tp, D2p, db


def eval_shear(gre, gim, Wd, TEre, TEim, PhiDre, PhiDim):
    """K3: see :func:`eval_shear_ref`. Two launches: the R stage (bf16
    tensor cores with bf16 tables), then the Wd epilogue, a stream over the
    dense Wd in its own type."""
    if _on_cpu(gre):
        return eval_shear_ref(gre, gim, Wd, TEre, TEim, PhiDre, PhiDim)
    name = "eval_shear"
    PB, F = gre.shape[0], gre.shape[-1]
    PT, DB, Tp, D2p, db = _eval_checks(
        name, dict(gre=gre, gim=gim, Wd=Wd, TEre=TEre, TEim=TEim,
                   PhiDre=PhiDre, PhiDim=PhiDim), Wd, PB, F)
    _shape(name, gre, (PB, Tp, F), "gre")
    _shape(name, gim, (PB, Tp, F), "gim")
    R = torch.empty((PB, DB, Tp, D2p), dtype=torch.float32, device=gre.device)
    out = torch.empty((PB, Tp, DB * db), dtype=torch.float32,
                      device=gre.device)
    rc = _build.load("shear_sum").dip_eval_fwd(
        *(t.data_ptr() for t in (gre, gim, Wd, TEre, TEim, PhiDre, PhiDim, R,
                                 out)),
        PB, PT, DB, Tp, D2p, db, F, int(Wd.dtype == torch.bfloat16),
        _stream(),
    )
    _raise_if(rc, name)
    eval_shear.launches += 1
    return out


def eval_shear_t(ob, Wd, TEre, TEim, PhiDre, PhiDim):
    """K4: see :func:`eval_shear_t_ref`. Two launches: the Wd
    pre-contraction (Rbar leaves rounded to the table type), then the phase
    products (bf16 tensor cores with bf16 tables)."""
    if _on_cpu(ob):
        return eval_shear_t_ref(ob, Wd, TEre, TEim, PhiDre, PhiDim)
    name = "eval_shear_t"
    PB, F = ob.shape[0], TEre.shape[-1]
    PT, DB, Tp, D2p, db = _eval_checks(
        name, dict(ob=ob, Wd=Wd, TEre=TEre, TEim=TEim, PhiDre=PhiDre,
                   PhiDim=PhiDim), Wd, PB, F, aligned=("Wd", "ob"))
    _shape(name, ob, (PB, Tp, DB * db), "ob")
    Rbar = torch.empty((PB, DB, Tp, D2p), dtype=Wd.dtype, device=ob.device)
    gre = torch.empty((PB, Tp, F), dtype=torch.float32, device=ob.device)
    gim = torch.empty_like(gre)
    rc = _build.load("shear_sum").dip_eval_t(
        *(t.data_ptr() for t in (ob, Wd, TEre, TEim, PhiDre, PhiDim, Rbar, gre,
                                 gim)),
        PB, PT, DB, Tp, D2p, db, F, int(Wd.dtype == torch.bfloat16),
        _stream(),
    )
    _raise_if(rc, name)
    eval_shear_t.launches += 1
    return gre, gim


KERNELS = (skew_sum_planes, skew_sum_planes_t, eval_shear, eval_shear_t,
           skew_sum_planes_t_rows, shear_sum_planes, shear_sum_planes_t,
           shear_sum, shear_sum_t)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
