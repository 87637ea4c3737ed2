"""The fused edge-consensus kernel (K5), with its plain version.

``consensus_update`` replaces the Pallas kernel ``consensus_update`` of
``dip_admm_tpu/ops/pallas/consensus.py`` (midpoint and weighted fusion);
on a CUDA tensor it launches ``dip_consensus`` of ``csrc/consensus.cu``,
on a CPU tensor it runs :func:`consensus_update_ref`.

Single device: the transposed proposals a_ji are read by index from ``a``
itself, so the caller passes no ``a_t`` (the JAX kernel takes one because
its sharded caller gathers it with an ``all_to_all``). The kernel's tile
need not divide n (the ragged last tile is masked), so the JAX package's
``pick_tile`` has no counterpart. What bounds it and why its reduction is
deterministic is in the source note of ``csrc/consensus.cu``.

``consensus_update.launches`` counts the calls that launch the kernel (one
per call, though a call is two launches: the fused pass and the sum of its
per-tile partials); ``launch_counts`` and ``reset_launch_counts`` read and
clear it.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build
from dip_admm_tpu_torch.ops.kernels.shear_sum import _on_cpu, _raise_if, _stream

TILE = 2048  # pixels per block of the fused pass
FUSIONS = ("midpoint", "weighted")


def consensus_update_ref(a, y, z, adjm, w=None, fusion="midpoint"):
    """Fused z/y/residual update of every edge slot, in plain torch ops.

    a, y, z: [P, P, n] proposals a_ij = x^_ij + y_ij, duals and previous
    consensus; adjm: [P, P] edge mask; w: [P, n] fusion weights (weighted
    only). Returns (z_new, y_new, pri_pair, dz2_pair) with the per-(i, j)
    partials pri = sum_p (a - y - z_new)^2 and dz2 = sum_p (z_new - z)^2
    over [P, P], masked."""
    a_t = a.transpose(0, 1)
    am = adjm[:, :, None].to(a.dtype)
    if fusion == "midpoint":
        zn = 0.5 * (a + a_t) * am
    else:
        wi = w[:, None, :]
        wj = w[None, :, :]
        zn = ((wi * a + wj * a_t) / (wi + wj)) * am
    yn = (a - zn) * am
    dpri = (a - y - zn) * am
    dz = (zn - z) * am
    return zn, yn, torch.sum(dpri * dpri, -1), torch.sum(dz * dz, -1)


def consensus_update(a, y, z, adjm, w=None, fusion="midpoint"):
    """K5: see :func:`consensus_update_ref`."""
    if fusion not in FUSIONS:
        raise ValueError(f"fusion must be one of {FUSIONS}, got {fusion!r}")
    if fusion == "weighted" and w is None:
        raise ValueError("weighted fusion needs the weights w")
    if _on_cpu(a):
        return consensus_update_ref(a, y, z, adjm, w, fusion)
    name = "consensus_update"
    P, _, n = a.shape
    tensors = dict(a=a, y=y, z=z, adjm=adjm)
    if fusion == "weighted":
        tensors["w"] = w
    shapes = dict(a=(P, P, n), y=(P, P, n), z=(P, P, n), adjm=(P, P),
                  w=(P, n))
    for k, t in tensors.items():
        if t.device != a.device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
    if P * P > 65535:
        raise ValueError(f"{name}: {P} nodes exceed the grid's pair axis")
    n_tiles = -(-n // TILE)
    zn = torch.empty_like(a)
    yn = torch.empty_like(a)
    part = torch.empty((2, P * P, n_tiles), dtype=torch.float32,
                       device=a.device)
    pri = torch.empty((P, P), dtype=torch.float32, device=a.device)
    dz2 = torch.empty_like(pri)
    lib = _build.load("consensus")
    rc = lib.dip_consensus(
        a.data_ptr(), y.data_ptr(), z.data_ptr(), adjm.data_ptr(),
        w.data_ptr() if fusion == "weighted" else None,
        zn.data_ptr(), yn.data_ptr(), part.data_ptr(), pri.data_ptr(),
        dz2.data_ptr(), P, n, TILE, int(fusion == "weighted"), _stream(),
    )
    _raise_if(rc, name)
    consensus_update.launches += 1
    return zn, yn, pri, dz2


consensus_update.launches = 0


def launch_counts() -> dict:
    return {"consensus_update": consensus_update.launches}


def reset_launch_counts() -> None:
    consensus_update.launches = 0
