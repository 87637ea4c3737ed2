"""Branch-grouped angle planning, the slot permutation, and the two
kernels of projector mode ``fft_mxu`` with their plain versions.

Every node's angles are regrouped at table-build time so that each
tt-angle block reads one image orientation ("plane": 0 = the image,
1 = its transpose, for angles with |cos| > |sin|). Slots past the real
angles are slack: their table rows are zero. The skew, shear, grouped and
mxu projectors all use the planner and the row gather.

``fft_mxu`` keeps the branch-grouped phase table pair pre-tiled
(:func:`tile_table`) to [PT, Fpad/128, N/tn, Tp, tn*128], the frequencies
padded to Fpad = ceil(F/128)*128 with zeros. Each wrapper replaces one
Pallas kernel of ``dip_admm_tpu/ops/pallas/filter_mxu.py``:

================== ================================= ===========
wrapper            TPU kernel it replaces            CUDA entry
================== ================================= ===========
filter_sum_mxu     filter_sum_mxu (_fwd_pallas)      dip_mxu_fwd
filter_sum_mxu_t   filter_sum_mxu_t (_adj_pallas)    dip_mxu_t
================== ================================= ===========

    g[p, t, f] = sum_n r_s[p, blk(t), n, f] * H[p % PT, t, n, f]

with r_s [PB, TB, N, Fpad] f32 (each slot block's spectrum plane), H the
untiled table, g [PB, Tp, Fpad] f32, and the transpose a pure map over slot
blocks. With bf16 tables the forward rounds r_s to bf16 before the product
(the TPU kernel casts its spectra to the table dtype for the MXU); the
transpose upcasts H and stays f32. On a CPU tensor a wrapper runs its
plain PyTorch version (``*_ref``); on a CUDA tensor it launches the
hand-written kernel of ``csrc/filter_mxu.cu`` or raises, through the launch
path of ``_launch.py`` (the alignment tests run on every call). Each wrapper
counts its launches in ``<wrapper>.launches``; ``launch_counts`` and
``reset_launch_counts`` read and clear them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as fn

from dip_admm_tpu_torch.ops.kernels import _launch
from dip_admm_tpu_torch.ops.kernels._launch import (
    _batches, _check, _on_cpu, _shape, _stream,
)
from dip_admm_tpu_torch.ops.kernels.filter_sum import (
    filter_sum_grouped_ref, filter_sum_grouped_t_ref,
)

_FW = 128  # frequencies per tile of the tiled table


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_branch_groups(
    use_c: np.ndarray,
    valid: np.ndarray,
    tt_candidates=(32, 16, 8),
    max_overhead: float = 1.15,
):
    """Per-node angle regrouping so every tt-angle block is single-branch.

    use_c, valid: [P, T] bool (branch-C selector / angle validity).

    Returns a dict of numpy arrays:
      tt        : chosen angle block (int)
      Tp        : padded slot count (int, multiple of tt, >= T)
      src_slot  : [P, Tp] int32, original angle index feeding each slot
                  (-1 = slack slot, table row zeroed)
      posfull   : [P, Tp] int32 bijection, slot of original index i
      invposfull: [P, Tp] int32 inverse bijection
      onehot    : [P, TB, 2] f32, plane of each angle block

    tt is the largest candidate whose zero-row padding keeps Tp/T below
    ``max_overhead``.
    """
    use_c = np.asarray(use_c, bool)
    valid = np.asarray(valid, bool)
    P, T = use_c.shape
    key = np.where(valid, use_c.astype(np.int64), 2)
    n0 = (key == 0).sum(axis=1)
    n1 = (key == 1).sum(axis=1)

    tt = tt_candidates[-1]
    Tp = None
    for cand in tt_candidates:
        need = max(
            int(
                max(
                    _ceil_to(int(a), cand) + _ceil_to(int(b), cand)
                    for a, b in zip(n0, n1)
                )
            ),
            _ceil_to(T, cand),
        )
        if need <= max_overhead * T or cand == tt_candidates[-1]:
            tt, Tp = cand, need
            break

    TB = Tp // tt
    src_slot = np.full((P, Tp), -1, np.int32)
    posfull = np.zeros((P, Tp), np.int32)
    onehot = np.zeros((P, TB, 2), np.float32)
    for i in range(P):
        order = np.argsort(key[i], kind="stable")
        o1 = _ceil_to(int(n0[i]), tt)
        o2 = o1 + _ceil_to(int(n1[i]), tt)
        slot_of = np.empty(T, np.int32)
        slot_of[order[: n0[i]]] = np.arange(n0[i])
        slot_of[order[n0[i] : n0[i] + n1[i]]] = o1 + np.arange(n1[i])
        # invalid angles -> slack slots (zero table rows -> zero output rows)
        slack = np.setdiff1d(np.arange(Tp), slot_of[order[: n0[i] + n1[i]]])
        n_inv = T - n0[i] - n1[i]
        slot_of[order[n0[i] + n1[i] :]] = slack[:n_inv]
        src_slot[i, slot_of] = np.arange(T)
        posfull[i, :T] = slot_of
        posfull[i, T:] = slack[n_inv:]
        blk = np.arange(TB) * tt
        plane1 = (blk >= o1) & (blk < o2)
        onehot[i, :, 1] = plane1.astype(np.float32)
        onehot[i, :, 0] = 1.0 - onehot[i, :, 1]
    invposfull = np.argsort(posfull, axis=1).astype(np.int32)
    return dict(
        tt=int(tt),
        Tp=int(Tp),
        src_slot=src_slot,
        posfull=posfull,
        invposfull=invposfull,
        onehot=onehot,
    )


def permute_rows(g: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """y[p, i] = g[p, perm[p % PT, i]], a bijective row gather of g [PB, Tp,
    ...] by the PT plans of ``perm`` [PT, Tp] (PT divides PB). Its transpose
    is the same gather with the inverse permutation."""
    perm = perm.long().repeat(g.shape[0] // perm.shape[0], 1)
    idx = perm[:, :, None].expand(-1, -1, g.shape[2])
    return torch.gather(g, 1, idx)


def pick_tn(N: int, want: int = 32) -> int:
    """Row tile: largest multiple-of-8 divisor of N that is <= want (halving
    from ``want``), N itself if none."""
    t = want
    while t >= 8:
        if N % t == 0 and t % 8 == 0:
            return t
        t //= 2
    return N


def tile_table(H: torch.Tensor, src_slot: torch.Tensor, Fpad: int,
               tn: int) -> torch.Tensor:
    """One real table plane [P, T, N, F] -> [P, Fpad/128, N/tn, Tp, tn*128],
    rows permuted into the slot order of ``src_slot`` [P, Tp] (slack slots,
    -1, zero) and frequencies zero-padded to Fpad."""
    P, T, N, F = H.shape
    Tp = src_slot.shape[1]
    src = src_slot.long()
    Hp = torch.gather(H, 1, src.clamp(min=0)[:, :, None, None].expand(
        -1, -1, N, F))
    Hp = Hp * (src >= 0)[:, :, None, None].to(H.dtype)
    Hp = fn.pad(Hp, (0, Fpad - F))
    NB, FB = N // tn, Fpad // _FW
    Hp = Hp.reshape(P, Tp, NB, tn, FB, _FW).permute(0, 4, 2, 1, 3, 5)
    return Hp.reshape(P, FB, NB, Tp, tn * _FW).contiguous()


def untile_table(Ht: torch.Tensor) -> torch.Tensor:
    """Inverse layout of :func:`tile_table`: [PT, FB, NB, Tp, tn*128] ->
    [PT, Tp, NB*tn, FB*128] (slot order, padded frequencies kept)."""
    PT, FB, NB, Tp, L = Ht.shape
    tn = L // _FW
    H = Ht.reshape(PT, FB, NB, Tp, tn, _FW).permute(0, 3, 2, 4, 1, 5)
    return H.reshape(PT, Tp, NB * tn, FB * _FW)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def filter_sum_mxu_ref(rre, rim, Hre_t, Him_t):
    """K15's function (module docstring) on the untiled table, with the
    spectra rounded to bf16 when the table is bf16."""
    if Hre_t.dtype == torch.bfloat16:
        rre, rim = (r.to(torch.bfloat16).float() for r in (rre, rim))
    return filter_sum_grouped_ref(rre, rim, untile_table(Hre_t),
                                  untile_table(Him_t))


def filter_sum_mxu_t_ref(gre_b, gim_b, Hre_t, Him_t, TB: int):
    """Exact transpose of :func:`filter_sum_mxu_ref` with respect to the
    (rounded) spectra: [PB, Tp, Fpad] pair -> [PB, TB, N, Fpad] pair."""
    return filter_sum_grouped_t_ref(gre_b, gim_b, untile_table(Hre_t),
                                    untile_table(Him_t), TB)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_MXU_FWD = _launch.Entry("filter_mxu", "dip_mxu_fwd", "filter_sum_mxu")
_MXU_T = _launch.Entry("filter_mxu", "dip_mxu_t", "filter_sum_mxu_t")


def _check_tiled(name, fwd, names, a, b, Hre_t, Him_t, TB):
    """K15's (``fwd``: a, b the block spectra) or K16's (a, b the
    cotangents) checks of the metadata: device, type, contiguity and
    shapes; ``names`` names a and b. Returns (PB, PT, TB, Tp, N, tn, FB,
    bf16). The 16-byte alignment of the kernels' vector loads is
    :func:`_aligned`'s, on every call."""
    PT, FB, NB, Tp, L = Hre_t.shape
    _shape(name, Him_t, Hre_t.shape, "Him_t")
    if L % _FW or TB < 1 or Tp % TB:
        raise ValueError(f"{name}: table rows of {L} values, Tp={Tp} and "
                         f"TB={TB} do not tile")
    _check(name, {**dict(zip(names, (a, b))), "Hre_t": Hre_t,
                  "Him_t": Him_t}, a.device, Hre_t.dtype)
    PB, tn = a.shape[0], L // _FW
    _batches(name, PB, PT)
    N, Fpad = NB * tn, FB * _FW
    for k, t in zip(names, (a, b)):
        _shape(name, t, (PB, TB, N, Fpad) if fwd else (PB, Tp, Fpad), k)
    return PB, PT, TB, Tp, N, tn, FB, int(Hre_t.dtype == torch.bfloat16)


def _aligned(name, fwd, names, a, b, Hre_t, Him_t, TB):
    """The kernels' 16-byte vector loads: per call, by address."""
    for k, t in zip((*names, "Hre_t", "Him_t"), (a, b, Hre_t, Him_t)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} is not 16-byte aligned")


_checks = _launch.Checked(_check_tiled, _aligned)


def filter_sum_mxu(rre, rim, Hre_t, Him_t):
    """K15: see :func:`filter_sum_mxu_ref`. ``rre``/``rim`` [PB, TB, N,
    Fpad]; returns the [PB, Tp, Fpad] pair in slot order."""
    if _on_cpu(rre):
        return filter_sum_mxu_ref(rre, rim, Hre_t, Him_t)
    args = _checks("filter_sum_mxu", True, ("rre", "rim"), rre, rim, Hre_t,
                   Him_t, rre.shape[1])
    PB, _, _, Tp, _, _, FB, _ = args
    gre, gim = (rre.new_empty((PB, Tp, FB * _FW)) for _ in range(2))
    _MXU_FWD(*(t.data_ptr() for t in (rre, rim, Hre_t, Him_t, gre, gim)),
             *args, _stream())
    filter_sum_mxu.launches += 1
    return gre, gim


def filter_sum_mxu_t(gre_b, gim_b, Hre_t, Him_t, TB: int):
    """K16: see :func:`filter_sum_mxu_t_ref`. ``TB`` is the number of slot
    blocks (the JAX entry reads it off the plan's ``onehot`` table)."""
    if _on_cpu(gre_b):
        return filter_sum_mxu_t_ref(gre_b, gim_b, Hre_t, Him_t, TB)
    args = _checks("filter_sum_mxu_t", False, ("gre_b", "gim_b"), gre_b,
                   gim_b, Hre_t, Him_t, TB)
    PB, _, _, _, N, _, FB, _ = args
    rre, rim = (gre_b.new_empty((PB, TB, N, FB * _FW)) for _ in range(2))
    _MXU_T(*(t.data_ptr() for t in (gre_b, gim_b, Hre_t, Him_t, rre, rim)),
           *args, _stream())
    filter_sum_mxu_t.launches += 1
    return rre, rim


launch_counts, reset_launch_counts = _launch.counters(filter_sum_mxu,
                                                      filter_sum_mxu_t)
