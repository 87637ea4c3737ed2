"""The two kernels of the ``fft_grouped`` projector, with their plain versions.

Each wrapper replaces one Pallas kernel of
``dip_admm_tpu/ops/pallas/filter_sum.py``:

===================== ================================================ ===========
wrapper               TPU kernel it replaces                           CUDA entry
===================== ================================================ ===========
filter_sum_grouped    filter_sum_grouped (_fwd_grp_pallas)             dip_grp_fwd
filter_sum_grouped_t  filter_sum_grouped_t (_t_grp_pallas)             dip_grp_t
===================== ================================================ ===========

The branch-grouped filter-sum contracts each slot block's spectrum plane
with the merged phase table, as a complex product in re/im planes:

    g[p, t, f] = sum_n r_s[p, blk(t), n, f] * H[p % PT, t, n, f]

r_s [PB, TB, N, F] f32 (the block's selected spectrum plane), H [PT, Tp, N,
F] f32 or bf16 (upcast, f32 accumulation), g [PB, Tp, F] f32. The image
batch PB is a multiple of the table batch PT: the parallel path runs
PT = PB, the fan-beam path its node images against one shared table set
(PT = 1), as the JAX kernels' vmap rule folds an image batch into the node
axis. The transpose is a pure map: each slot block owns its output block.

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


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


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


def filter_sum_grouped(rre_s, rim_s, Hre_g, Him_g):
    """K13: see :func:`filter_sum_grouped_ref`."""
    if _on_cpu(rre_s):
        return filter_sum_grouped_ref(rre_s, rim_s, Hre_g, Him_g)
    name = "filter_sum_grouped"
    PB, TB = rre_s.shape[:2]
    PT, Tp, N, F = _check_tables(name, Hre_g, Him_g, TB)
    _check(name, dict(rre_s=rre_s, rim_s=rim_s, Hre_g=Hre_g, Him_g=Him_g),
           rre_s.device, Hre_g.dtype)
    _batches(name, PB, PT)
    _shape(name, rre_s, (PB, TB, N, F), "rre_s")
    _shape(name, rim_s, (PB, TB, N, F), "rim_s")
    gre = torch.empty((PB, Tp, F), dtype=torch.float32, device=rre_s.device)
    gim = torch.empty_like(gre)
    lib = _build.load("filter_sum")
    rc = lib.dip_grp_fwd(
        *(t.data_ptr() for t in (rre_s, rim_s, Hre_g, Him_g, gre, gim)),
        PB, PT, TB, Tp, N, F, int(Hre_g.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    filter_sum_grouped.launches += 1
    return gre, gim


def filter_sum_grouped_t(gre_b, gim_b, Hre_g, Him_g, TB: int):
    """K14: see :func:`filter_sum_grouped_t_ref`. ``TB`` is the number of
    slot blocks (the JAX entry reads it off the plan's ``onehot`` table)."""
    if _on_cpu(gre_b):
        return filter_sum_grouped_t_ref(gre_b, gim_b, Hre_g, Him_g, TB)
    name = "filter_sum_grouped_t"
    PB = gre_b.shape[0]
    PT, Tp, N, F = _check_tables(name, Hre_g, Him_g, TB)
    _check(name, dict(gre_b=gre_b, gim_b=gim_b, Hre_g=Hre_g, Him_g=Him_g),
           gre_b.device, Hre_g.dtype)
    _batches(name, PB, PT)
    _shape(name, gre_b, (PB, Tp, F), "gre_b")
    _shape(name, gim_b, (PB, Tp, F), "gim_b")
    rre = torch.empty((PB, TB, N, F), dtype=torch.float32, device=gre_b.device)
    rim = torch.empty_like(rre)
    lib = _build.load("filter_sum")
    rc = lib.dip_grp_t(
        *(t.data_ptr() for t in (gre_b, gim_b, Hre_g, Him_g, rre, rim)),
        PB, PT, TB, Tp, N, F, int(Hre_g.dtype == torch.bfloat16), _stream(),
    )
    _raise_if(rc, name)
    filter_sum_grouped_t.launches += 1
    return rre, rim


KERNELS = (filter_sum_grouped, filter_sum_grouped_t)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
