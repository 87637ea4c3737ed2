"""The fused edge-consensus kernel (K5), with its plain version.

``consensus_update`` replaces the Pallas kernel ``consensus_update`` of
``dip_admm_tpu/ops/pallas/consensus.py`` (midpoint and weighted fusion);
on a CUDA tensor it launches ``dip_consensus`` of ``csrc/consensus.cu``,
on a CPU tensor it runs :func:`consensus_update_ref`.

Single device: the transposed proposals a_ji are read from ``a`` itself,
so the caller passes no ``a_t``; the kernel reads each proposal once and
updates both (i, j) and (j, i) from it. It also takes a leading batch axis,
a, y, z [B, P, P, n] against one graph and one set of weights (scenario
batching, ``core/admm.run_admm_batched``), in the same one launch; each
lane gives what a call on it alone gives, bit for bit. (The JAX package
turns its kernel off under batching and computes the same function with
XLA ops.) The sharded form takes the JAX
kernel's contract: the node x pixel mesh (``parallel/admm_sharded.py``)
gathers ``a_t`` [P_loc, P, n_loc] with an ``all_to_all`` and passes the
fusion weights as ``w_own`` [P_loc, n_loc] and ``w_all`` [P, n_loc]; it
launches ``dip_consensus_sharded``. Any n is taken (16-byte streams where
n % 4 == 0, else a scalar path), so the JAX package's ``pick_tile`` has no
counterpart. Each call is one launch, through the lean launch path of
``_launch.py``; what bounds it and why its cluster reduction is
deterministic is in the source note of ``csrc/consensus.cu``.

``consensus_update.launches`` counts the single-device calls that launch
the kernel and ``consensus_update.sharded_launches`` the sharded ones;
``launch_counts`` and ``reset_launch_counts`` read and clear them.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build, _launch
from dip_admm_tpu_torch.ops.kernels.shear_sum import _on_cpu, _stream

FUSIONS = ("midpoint", "weighted")


def consensus_update_ref(a, y, z, adjm, w=None, fusion="midpoint", *,
                         a_t=None, w_own=None, w_all=None):
    """Fused z/y/residual update of every edge slot, in plain torch ops.

    a, y, z: [P, P, n] proposals a_ij = x^_ij + y_ij, duals and previous
    consensus, or [B, P, P, n], a batch of them; adjm: [P, P] edge mask;
    w: [P, n] fusion weights (weighted only). Returns (z_new, y_new,
    pri_pair, dz2_pair) with the per-(i, j) partials pri = sum_p (a - y -
    z_new)^2 and dz2 = sum_p (z_new - z)^2 over [P, P] ([B, P, P]),
    masked.

    Sharded form: ``a_t`` [P_loc, P, n] holds a_ji for a, y, z [P_loc, P,
    n] and adjm [P_loc, P], with the weights ``w_own`` [P_loc, n] and
    ``w_all`` [P, n] in place of ``w``."""
    if a_t is None:
        a_t = a.transpose(-3, -2)
        w_own = w_all = w
    am = adjm[:, :, None].to(a.dtype)
    if fusion == "midpoint":
        zn = 0.5 * (a + a_t) * am
    else:
        wi = w_own[:, None, :]
        wj = w_all[None, :, :]
        zn = ((wi * a + wj * a_t) / (wi + wj)) * am
    yn = (a - zn) * am
    dpri = (a - y - zn) * am
    dz = (zn - z) * am
    return zn, yn, torch.sum(dpri * dpri, -1), torch.sum(dz * dz, -1)


def _check_update(a, y, z, adjm, w, fusion, a_t, w_own, w_all):
    """The tensor checks of :func:`consensus_update`: (P_loc, P, n)."""
    name = "consensus_update"
    if a.dim() == 4 and a_t is None:
        B, P_loc, P, n = a.shape
        lead = (B,)
    elif a.dim() == 3:
        (P_loc, P, n), B, lead = a.shape, 0, ()
    else:
        raise ValueError(f"{name}: a has shape {tuple(a.shape)}; expected "
                         "[P, P, n], [B, P, P, n] or (with a_t) [P_loc, P, n]")
    tensors = dict(a=a, y=y, z=z, adjm=adjm)
    edge = lead + (P_loc, P, n)
    shapes = dict(a=edge, y=edge, z=edge, a_t=(P_loc, P, n),
                  adjm=(P_loc, P), w=(P, n), w_own=(P_loc, n), w_all=(P, n))
    if a_t is not None:
        tensors["a_t"] = a_t
        if fusion == "weighted":
            tensors.update(w_own=w_own, w_all=w_all)
    else:
        if P_loc != P:
            raise ValueError(f"{name}: a is {tuple(a.shape)}; a [P_loc, P, "
                             "n] needs the sharded form's a_t")
        if fusion == "weighted":
            tensors["w"] = w
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
    if P_loc * P > 65535:
        raise ValueError(f"{name}: {P_loc} x {P} pairs exceed the grid's "
                         "pair axis")
    if B > 65535:
        raise ValueError(f"{name}: a batch of {B} exceeds the grid's batch "
                         "axis")
    return P_loc, P, n


_checks = _launch.Checked(_check_update)
_HALF = (torch.bfloat16, torch.float16)
_SINGLE = _launch.Entry("consensus", "dip_consensus", "consensus_update")
_SHARDED = _launch.Entry("consensus", "dip_consensus_sharded",
                         "consensus_update")


def consensus_update(a, y, z, adjm, w=None, fusion="midpoint", *,
                     a_t=None, w_own=None, w_all=None):
    """K5: see :func:`consensus_update_ref` (its batched form with a 4-d
    ``a``, its sharded form with ``a_t``)."""
    if fusion not in FUSIONS:
        raise ValueError(f"fusion must be one of {FUSIONS}, got {fusion!r}")
    sharded = a_t is not None
    weighted = fusion == "weighted"
    if weighted and (
            (w_own is None or w_all is None) if sharded else w is None):
        raise ValueError("weighted fusion needs the weights "
                         + ("w_own and w_all" if sharded else "w"))
    if _on_cpu(a):
        return consensus_update_ref(a, y, z, adjm, w, fusion, a_t=a_t,
                                    w_own=w_own, w_all=w_all)
    if any(t is not None and t.dtype in _HALF
           for t in (a, y, z, adjm, w, a_t, w_own, w_all)):
        # K5 computes in float32: a half-precision problem's tensors are
        # cast in here, and its results out to the state's dtype.
        def f32(t):
            return None if t is None else t.to(torch.float32)

        return tuple(o.to(a.dtype) for o in consensus_update(
            f32(a), f32(y), f32(z), f32(adjm), f32(w), fusion, a_t=f32(a_t),
            w_own=f32(w_own), w_all=f32(w_all)))
    P_loc, P, n = _checks(a, y, z, adjm, w, fusion, a_t, w_own, w_all)
    B = a.shape[0] if a.dim() == 4 else 0  # checked: only without a_t
    # Four allocations shaped like checked inputs: cheaper on the host than
    # two and the views that split them.
    zn, yn = torch.empty_like(a), torch.empty_like(a)
    if B:
        pri = torch.empty((B, P, P), dtype=a.dtype, device=a.device)
        dz2 = torch.empty((B, P, P), dtype=a.dtype, device=a.device)
    else:
        pri, dz2 = torch.empty_like(adjm), torch.empty_like(adjm)
    outs = (zn.data_ptr(), yn.data_ptr(), pri.data_ptr(), dz2.data_ptr())
    if sharded:
        _SHARDED(a.data_ptr(), y.data_ptr(), z.data_ptr(), a_t.data_ptr(),
                 adjm.data_ptr(), w_own.data_ptr() if weighted else None,
                 w_all.data_ptr() if weighted else None, *outs, P_loc, P, n,
                 weighted, _stream())
        consensus_update.sharded_launches += 1
    else:
        _SINGLE(a.data_ptr(), y.data_ptr(), z.data_ptr(), adjm.data_ptr(),
                w.data_ptr() if weighted else None, *outs, max(B, 1), P, n,
                weighted, _stream())
        consensus_update.launches += 1
    return zn, yn, pri, dz2


def max_active_clusters(sharded: bool, weighted: bool) -> int:
    """How many of the kernel's clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``); the kernel's launch needs one."""
    return _build.load("consensus").dip_consensus_clusters(int(sharded),
                                                            int(weighted))


consensus_update.launches = 0
consensus_update.sharded_launches = 0


def launch_counts() -> dict:
    return {"consensus_update": consensus_update.launches,
            "consensus_update_sharded": consensus_update.sharded_launches}


def reset_launch_counts() -> None:
    consensus_update.launches = 0
    consensus_update.sharded_launches = 0
