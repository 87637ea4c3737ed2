"""Branch-grouped angle planning and the slot permutation.

No kernel lives here: the JAX module of the same name also holds the
``filter_sum_mxu`` Pallas kernels of projector mode ``fft_mxu``, which is
not ported yet. The skew and grouped projectors need only the planner and
the row gather.

Every node's angles are regrouped at table-build time so that each
tt-angle block reads one image orientation ("plane": 0 = the image,
1 = its transpose, for angles with |cos| > |sin|). Slots past the real
angles are slack: their table rows are zero.
"""

from __future__ import annotations

import numpy as np
import torch


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
