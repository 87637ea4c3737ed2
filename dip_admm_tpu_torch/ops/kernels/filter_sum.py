"""The filter-sum kernels of the ``fft_pallas`` and ``fft_grouped``
projectors, with their plain versions.

Each wrapper replaces one Pallas kernel of
``dip_admm_tpu/ops/pallas/filter_sum.py``:

===================== ================================================ ===========
wrapper               TPU kernel it replaces                           CUDA entry
===================== ================================================ ===========
filter_sum_sel        filter_sum_sel (_fwd_sel_pallas)                 dip_sel_fwd
filter_sum_sel_t      filter_sum_sel_t (_t_sel_pallas)                 dip_sel_t
filter_sum_grouped    filter_sum_grouped (_fwd_grp_pallas)             dip_grp_fwd
filter_sum_grouped_t  filter_sum_grouped_t (_t_grp_pallas)             dip_grp_t
===================== ================================================ ===========

The merged-branch filter-sum (``fft_pallas``) contracts, per angle t, the
spectrum plane that the selector picks (0 = image rows, 1 = transposed
image rows) with the merged phase table, as a complex product in re/im
planes:

    g[p, t, f] = sum_n r[p, sel[p % PT, t], n, f] * H[p % PT, t, n, f]

r [PB, 2, N, F] f32, H [PT, T, N, F] f32 or bf16 (upcast, f32
accumulation), sel [PT, T, 1] f32 in {0, 1}, g [PB, T, F] f32. Its
transpose routes each angle's conj(H) contraction to the selected plane;
a plane that no angle selects comes out zero.

The branch-grouped filter-sum (``fft_grouped``) contracts each slot block's
spectrum plane instead:

    g[p, t, f] = sum_n r_s[p, blk(t), n, f] * H[p % PT, t, n, f]

r_s [PB, TB, N, F] f32 (the block's selected spectrum plane), H [PT, Tp, N,
F], g [PB, Tp, F]. Its transpose is a pure map: each slot block owns its
output block.

The image batch PB is a multiple of the table batch PT: the parallel paths
run PT = PB, the fan-beam path its node images against one shared table set
(PT = 1), as the JAX kernels' vmap rule folds an image batch into the node
axis.

All four kernels read the table rows, the spectrum rows (K11's r, K13's
r_s) and the cotangent rows (K12's and K14's gbar) with 16-byte loads, so
on the card those tensors must be *pitched*: the last stride 1, a row
pitch that is a multiple of ``PITCH`` elements and at least F, the outer
strides dense over that pitch, the first row 16-byte aligned and the last
row's padding inside the storage. :func:`pitched_zeros` makes such
storage (zero pad columns) and hands it out as the [..., F] view, so
shapes and plain versions do not change; a contiguous tensor whose F is a
multiple of ``PITCH`` also qualifies. A slice along a leading dim keeps the pitch; ``.contiguous()``,
``.to(device)`` and the like do not. The wrappers never copy to get
there: anything else raises ``ValueError``. :func:`padded` is the one
reader of that padding: it widens a view over it, so that a product with
the widened operand comes out pitched.

On a CPU tensor a wrapper runs its plain PyTorch version (``*_ref``); on a
CUDA tensor it launches the hand-written kernel of ``csrc/filter_sum.cu``
or raises. What bounds the kernels and how they are laid out is in the
source note there. Each wrapper counts its launches in
``<wrapper>.launches``; ``launch_counts`` and ``reset_launch_counts`` read
and clear them.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build
from dip_admm_tpu_torch.ops.kernels.shear_sum import (
    _batches, _check, _on_cpu, _raise_if, _shape, _stream,
)


PITCH = 8  # elements: 16 bytes of bf16, two 16-byte loads of f32


def pitched_zeros(shape, dtype, device, dim: int = -1) -> torch.Tensor:
    """Zeros of ``shape`` in storage whose ``dim`` is padded with zeros to
    a multiple of ``PITCH``, as the ``shape`` view (fill it in place:
    ``pitched_zeros(x.shape, x.dtype, x.device).copy_(x)`` is the pitched
    copy of ``x``). ``dim`` = -1 pitches the rows, as the kernels stream
    them; -2 pads the rows of a matrix whose products then come out pitched
    (the irfft rows ``Cre``/``Cim`` [P, F, Np] of the ``fft_pallas`` and
    ``fft_grouped`` tables)."""
    return _pitched(shape, dtype, device, dim, torch.zeros)


def _pitched(shape, dtype, device, dim, alloc) -> torch.Tensor:
    full = list(shape)
    full[dim] = -(-full[dim] // PITCH) * PITCH
    return alloc(full, dtype=dtype, device=device).narrow(dim, 0, shape[dim])


def padded(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` widened along ``dim`` over the zero padding of
    :func:`pitched_zeros`'s layout, or ``x`` itself where its storage has
    no such padding (a dense, expanded or transposed tensor): the operand
    whose products come out pitched (the row-DFT columns ``Ere``/``Eim``
    at ``dim`` = -1 give pitched spectra, the irfft rows ``Cre``/``Cim``
    at -2 pitched cotangents)."""
    n, step, outer = x.shape[dim], x.stride(dim), x.stride(dim - 1)
    full = outer // step if step > 0 and outer % step == 0 else 0
    if full % PITCH or not n < full < n + PITCH:
        return x
    shape = list(x.shape)
    shape[dim] = full
    if _end(x, shape) > x.untyped_storage().nbytes():
        return x
    return x.as_strided(shape, x.stride(), x.storage_offset())


def _end(x: torch.Tensor, shape) -> int:
    """The byte just past the last element of the view of ``x``'s storage
    at ``shape`` and ``x``'s strides."""
    last = sum((d - 1) * s for d, s in zip(shape, x.stride()))
    return (x.storage_offset() + last + 1) * x.element_size()


def _check_pitched(name: str, what: str, x: torch.Tensor) -> int:
    """The row pitch of ``x`` [..., F] in elements, if the kernels can
    stream its rows, the last row's padding included (see the module
    docstring); else ValueError."""
    F, pitch = x.shape[-1], x.stride(-2)
    ok = (x.stride(-1) == 1 and pitch % PITCH == 0 and pitch >= F
          and x.data_ptr() % 16 == 0
          and _end(x, (*x.shape[:-1], pitch)) <= x.untyped_storage().nbytes())
    dense = pitch
    for d in range(x.dim() - 2, -1, -1):
        ok = ok and (x.stride(d) == dense or x.shape[d] == 1)
        dense *= x.shape[d]
    if not ok:
        raise ValueError(
            f"{name}: {what} needs rows of a pitch that is a multiple of "
            f"{PITCH} elements (>= F), dense over it, 16-byte aligned and "
            f"held whole by its storage (filter_sum.pitched_zeros); got "
            f"shape {tuple(x.shape)}, strides {x.stride()}")
    return pitch


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def filter_sum_sel_ref(rre2, rim2, Hre, Him, sel):
    """Merged-branch contraction (see the module docstring), as the JAX
    package's ``filter_sum_sel_reference`` computes it: both planes read and
    blended by ``sel``."""
    PT, T, N, F = Hre.shape
    PB = rre2.shape[0]
    _batches("plain version", PB, PT)
    s = sel.reshape(1, PT, T, 1, 1)
    xr = rre2.reshape(PB // PT, PT, 1, 2, N, F)
    xi = rim2.reshape(PB // PT, PT, 1, 2, N, F)
    rre = xr[:, :, :, 0] + s * (xr[:, :, :, 1] - xr[:, :, :, 0])
    rim = xi[:, :, :, 0] + s * (xi[:, :, :, 1] - xi[:, :, :, 0])
    hr, hi = Hre.float(), Him.float()
    g_re = (rre * hr - rim * hi).sum(dim=3)  # [K, PT, T, F]
    g_im = (rre * hi + rim * hr).sum(dim=3)
    return g_re.reshape(PB, T, F), g_im.reshape(PB, T, F)


def filter_sum_sel_t_ref(gre_b, gim_b, Hre, Him, sel):
    """Exact transpose of :func:`filter_sum_sel_ref` with respect to
    (rre2, rim2): [PB, T, F] pair -> [PB, 2, N, F] pair, each angle's
    cotangent gated onto its plane as the JAX kernel gates it."""
    PT, T, N, F = Hre.shape
    PB = gre_b.shape[0]
    _batches("plain version", PB, PT)
    s = sel.reshape(1, PT, T, 1)
    gr = gre_b.reshape(PB // PT, PT, T, F)
    gi = gim_b.reshape(PB // PT, PT, T, F)
    hr, hi = Hre.float(), Him.float()
    planes_re, planes_im = [], []
    for gate in (1.0 - s, s):
        a, b = gr * gate, gi * gate
        planes_re.append(torch.einsum("kptf,ptnf->kpnf", a, hr)
                         + torch.einsum("kptf,ptnf->kpnf", b, hi))
        planes_im.append(torch.einsum("kptf,ptnf->kpnf", b, hr)
                         - torch.einsum("kptf,ptnf->kpnf", a, hi))
    return (torch.stack(planes_re, dim=2).reshape(PB, 2, N, F),
            torch.stack(planes_im, dim=2).reshape(PB, 2, N, F))


def filter_sum_grouped_ref(rre_s, rim_s, Hre_g, Him_g):
    """Slot-order grouped contraction (see the module docstring)."""
    PT, Tp, N, F = Hre_g.shape
    PB, TB = rre_s.shape[:2]
    tt = Tp // TB
    xr = rre_s.reshape(PB // PT, PT, TB, 1, N, F)
    xi = rim_s.reshape(PB // PT, PT, TB, 1, N, F)
    hr = Hre_g.float().reshape(PT, TB, tt, N, F)
    hi = Him_g.float().reshape(PT, TB, tt, N, F)
    g_re = (xr * hr - xi * hi).sum(dim=-2)  # [K, PT, TB, tt, F]
    g_im = (xr * hi + xi * hr).sum(dim=-2)
    return g_re.reshape(PB, Tp, F), g_im.reshape(PB, Tp, F)


def filter_sum_grouped_t_ref(gre_b, gim_b, Hre_g, Him_g, TB):
    """Exact transpose of :func:`filter_sum_grouped_ref` with respect to
    (rre_s, rim_s): [PB, Tp, F] pair -> [PB, TB, N, F] pair."""
    PT, Tp, N, F = Hre_g.shape
    PB = gre_b.shape[0]
    tt = Tp // TB
    gr = gre_b.reshape(PB // PT, PT, TB, tt, 1, F)
    gi = gim_b.reshape(PB // PT, PT, TB, tt, 1, F)
    hr = Hre_g.float().reshape(PT, TB, tt, N, F)
    hi = Him_g.float().reshape(PT, TB, tt, N, F)
    r_re = (gr * hr + gi * hi).sum(dim=3)  # [K, PT, TB, N, F]
    r_im = (gi * hr - gr * hi).sum(dim=3)
    return r_re.reshape(PB, TB, N, F), r_im.reshape(PB, TB, N, F)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_tables(name, Hre_g, Him_g, TB):
    PT, Tp, N, F = Hre_g.shape
    _shape(name, Him_g, (PT, Tp, N, F), "Him_g")
    if TB < 1 or Tp % TB:
        raise ValueError(f"{name}: Tp={Tp} is not a multiple of TB={TB}")
    return PT, Tp, N, F


def _check_sel(name, tensors, streamed, device, table_dtype):
    """``_check`` on ``tensors``, the names in ``streamed`` held to
    :func:`_check_pitched` in place of contiguity. Returns their row
    pitches."""
    _check(name, tensors, device, table_dtype, strided=streamed)
    return {k: _check_pitched(name, k, tensors[k]) for k in streamed}


def _shared_pitch(name, pitch, a, b) -> int:
    if pitch[a] != pitch[b]:
        raise ValueError(f"{name}: {a} and {b} must share a row pitch, got "
                         f"{pitch[a]} and {pitch[b]}")
    return pitch[a]


def filter_sum_sel(rre2, rim2, Hre, Him, sel):
    """K11: see :func:`filter_sum_sel_ref`. The kernel reads only the plane
    each angle selects (sel > 0.5); for sel in {0, 1} that is the same sum.
    On the card ``rre2``/``rim2`` and the tables must be pitched."""
    if _on_cpu(rre2):
        return filter_sum_sel_ref(rre2, rim2, Hre, Him, sel)
    name = "filter_sum_sel"
    PB = rre2.shape[0]
    PT, T, N, F = Hre.shape
    _shape(name, Him, (PT, T, N, F), "Him")
    _shape(name, sel, (PT, T, 1), "sel")
    _batches(name, PB, PT)
    _shape(name, rre2, (PB, 2, N, F), "rre2")
    _shape(name, rim2, (PB, 2, N, F), "rim2")
    pitch = _check_sel(name, dict(rre2=rre2, rim2=rim2, Hre=Hre, Him=Him,
                                  sel=sel), ("rre2", "rim2", "Hre", "Him"),
                       rre2.device, Hre.dtype)
    hp = _shared_pitch(name, pitch, "Hre", "Him")
    rp = _shared_pitch(name, pitch, "rre2", "rim2")
    gre = torch.empty((PB, T, F), dtype=torch.float32, device=rre2.device)
    gim = torch.empty_like(gre)
    lib = _build.load("filter_sum")
    rc = lib.dip_sel_fwd(
        *(t.data_ptr() for t in (rre2, rim2, Hre, Him, sel, gre, gim)),
        PB, PT, T, N, F, hp, rp, int(Hre.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    filter_sum_sel.launches += 1
    return gre, gim


def filter_sum_sel_t(gre_b, gim_b, Hre, Him, sel):
    """K12: see :func:`filter_sum_sel_t_ref`. On the card the cotangents
    ``gre_b``/``gim_b`` and the tables must be pitched; the output is a
    pitched view (:func:`pitched_zeros`'s layout, pad columns written as
    zeros)."""
    if _on_cpu(gre_b):
        return filter_sum_sel_t_ref(gre_b, gim_b, Hre, Him, sel)
    name = "filter_sum_sel_t"
    PB = gre_b.shape[0]
    PT, T, N, F = Hre.shape
    _shape(name, Him, (PT, T, N, F), "Him")
    _shape(name, sel, (PT, T, 1), "sel")
    _batches(name, PB, PT)
    _shape(name, gre_b, (PB, T, F), "gre_b")
    _shape(name, gim_b, (PB, T, F), "gim_b")
    pitch = _check_sel(name, dict(gre_b=gre_b, gim_b=gim_b, Hre=Hre,
                                  Him=Him, sel=sel),
                       ("gre_b", "gim_b", "Hre", "Him"), gre_b.device,
                       Hre.dtype)
    hp = _shared_pitch(name, pitch, "Hre", "Him")
    gp = _shared_pitch(name, pitch, "gre_b", "gim_b")
    rre, rim = (_pitched((PB, 2, N, F), torch.float32, gre_b.device, -1,
                         torch.empty) for _ in range(2))
    lib = _build.load("filter_sum")
    rc = lib.dip_sel_t(
        *(t.data_ptr() for t in (gre_b, gim_b, Hre, Him, sel, rre, rim)),
        PB, PT, T, N, F, hp, gp, rre.stride(-2),
        int(Hre.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    filter_sum_sel_t.launches += 1
    return rre, rim


def grouped_images(PB: int, PT: int) -> int:
    """The images K that a K13 or K14 thread takes, all of one table set:
    2 where PB / PT is even, else 1. Each H segment a thread loads serves
    its K images from registers; see ``csrc/filter_sum.cu``."""
    return 2 if (PB // PT) % 2 == 0 else 1


def _check_grouped(name, tensors, Hre_g, device):
    """``_check_sel`` on a grouped kernel's tensors, all of them streamed:
    (table pitch, operand pitch)."""
    pitch = _check_sel(name, tensors, tuple(tensors), device, Hre_g.dtype)
    ops = [k for k in tensors if k not in ("Hre_g", "Him_g")]
    return (_shared_pitch(name, pitch, "Hre_g", "Him_g"),
            _shared_pitch(name, pitch, *ops))


def filter_sum_grouped(rre_s, rim_s, Hre_g, Him_g):
    """K13: see :func:`filter_sum_grouped_ref`. On the card ``rre_s``/
    ``rim_s`` and the tables must be pitched."""
    if _on_cpu(rre_s):
        return filter_sum_grouped_ref(rre_s, rim_s, Hre_g, Him_g)
    name = "filter_sum_grouped"
    PB, TB = rre_s.shape[:2]
    PT, Tp, N, F = _check_tables(name, Hre_g, Him_g, TB)
    _batches(name, PB, PT)
    _shape(name, rre_s, (PB, TB, N, F), "rre_s")
    _shape(name, rim_s, (PB, TB, N, F), "rim_s")
    hp, rp = _check_grouped(name, dict(rre_s=rre_s, rim_s=rim_s, Hre_g=Hre_g,
                                       Him_g=Him_g), Hre_g, rre_s.device)
    K = grouped_images(PB, PT)
    gre = torch.empty((PB, Tp, F), dtype=torch.float32, device=rre_s.device)
    gim = torch.empty_like(gre)
    lib = _build.load("filter_sum")
    rc = lib.dip_grp_fwd(
        *(t.data_ptr() for t in (rre_s, rim_s, Hre_g, Him_g, gre, gim)),
        PB, PT, TB, Tp, N, F, hp, rp, K, int(Hre_g.dtype == torch.bfloat16),
        _stream(),
    )
    _raise_if(rc, name)
    filter_sum_grouped.launches += 1
    return gre, gim


def filter_sum_grouped_t(gre_b, gim_b, Hre_g, Him_g, TB: int):
    """K14: see :func:`filter_sum_grouped_t_ref`. ``TB`` is the number of
    slot blocks (the JAX entry reads it off the plan's ``onehot`` table).
    On the card the cotangents ``gre_b``/``gim_b`` and the tables must be
    pitched; the output is a pitched view (:func:`pitched_zeros`'s layout,
    pad columns written as zeros)."""
    if _on_cpu(gre_b):
        return filter_sum_grouped_t_ref(gre_b, gim_b, Hre_g, Him_g, TB)
    name = "filter_sum_grouped_t"
    PB = gre_b.shape[0]
    PT, Tp, N, F = _check_tables(name, Hre_g, Him_g, TB)
    _batches(name, PB, PT)
    _shape(name, gre_b, (PB, Tp, F), "gre_b")
    _shape(name, gim_b, (PB, Tp, F), "gim_b")
    hp, gp = _check_grouped(name, dict(gre_b=gre_b, gim_b=gim_b, Hre_g=Hre_g,
                                       Him_g=Him_g), Hre_g, gre_b.device)
    K = grouped_images(PB, PT)
    rre, rim = (_pitched((PB, TB, N, F), torch.float32, gre_b.device, -1,
                         torch.empty) for _ in range(2))
    lib = _build.load("filter_sum")
    rc = lib.dip_grp_t(
        *(t.data_ptr() for t in (gre_b, gim_b, Hre_g, Him_g, rre, rim)),
        PB, PT, TB, Tp, N, F, hp, gp, rre.stride(-2), K,
        int(Hre_g.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    filter_sum_grouped_t.launches += 1
    return rre, rim


KERNELS = (filter_sum_sel, filter_sum_sel_t, filter_sum_grouped,
           filter_sum_grouped_t)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
