"""The hat-evaluation kernels of the projectors' eval tail, with their plain
versions.

Each wrapper replaces one Pallas kernel of
``dip_admm_tpu/ops/pallas/hat_eval.py``:

=========== ========================= ===========
wrapper     TPU kernel it replaces    CUDA entry
=========== ========================= ===========
hat_eval    hat_eval (_fwd_pallas)    dip_hat_fwd
hat_eval_t  hat_eval_t (_t_pallas)    dip_hat_t
=========== ========================= ===========

The tail evaluates each angle's summed profile g [PB, T, Np] at the
detector coordinates pc [PT, T, D] through the 2-tap hat
w(x) = max(0, 1 - |x|) and scales by s [PT, T, 1]:

    out[p, t, d] = s[q, t] * sum_v w(pc[q, t, d] - v) * g[p, t, v]

with q = p % PT (the image batch PB is a multiple of the geometry batch PT,
the JAX kernels' vmap rule). The transpose scatters detector cotangents back
onto the profile grid, gbar[p, t, v] = sum_d w(pc - v) * s * ob[p, t, d].
The projectors take these kernels where the materialized weights
w [PT, T, D, Np] would pass ``radon_fft._HAT_MAX_BYTES``, as the JAX package
does; everything is f32.

On a CPU tensor a wrapper runs its plain PyTorch version (``*_ref``, which
materializes w as the JAX package's reference does); on a CUDA tensor it
launches the hand-written kernel of ``csrc/hat_eval.cu`` or raises, through
the launch path of ``_launch.py`` (checks memoized by the inputs'
metadata, the C entry bound once). What
bounds the kernels and how they are laid out is in the source note there.
Each wrapper counts its launches in ``<wrapper>.launches``;
``launch_counts`` and ``reset_launch_counts`` read and clear them.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _launch
from dip_admm_tpu_torch.ops.kernels._launch import (
    _batches, _check, _on_cpu, _shape, _stream,
)

# K18 stages, per row, pc and s*ob (f32, [D]) and two boundary tables (u16,
# [Np]) in the shared memory of one block, at most 227 KB.
_MAX_SMEM = 232448


def _row_smem(D: int, Np: int) -> int:
    """Bytes of shared memory K18 stages for one row (a multiple of 16)."""
    return -(-(8 * D + 4 * Np) // 16) * 16


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _weights(pc, Np):
    """The materialized hat w[q, t, d, v] = max(0, 1 - |pc[q,t,d] - v|)."""
    v = torch.arange(Np, dtype=pc.dtype, device=pc.device)
    return torch.clamp(1.0 - torch.abs(pc[..., None] - v), min=0.0)


def hat_eval_ref(g, pc, s):
    """g [PB, T, Np], pc [PT, T, D], s [PT, T, 1] -> [PB, T, D] (see the
    module docstring), as the JAX package's ``hat_eval_reference``."""
    PT, T, _ = pc.shape
    PB, _, Np = g.shape
    _batches("plain version", PB, PT)
    out = torch.einsum("qtdv,kqtv->kqtd", _weights(pc, Np),
                       g.reshape(PB // PT, PT, T, Np))
    return (s * out).reshape(PB, T, -1)


def hat_eval_t_ref(ob, pc, s, Np: int):
    """Exact transpose of :func:`hat_eval_ref` with respect to g:
    ob [PB, T, D] -> [PB, T, Np]."""
    PT, T, D = pc.shape
    PB = ob.shape[0]
    _batches("plain version", PB, PT)
    gb = torch.einsum("qtdv,kqtd->kqtv", _weights(pc, Np),
                      s * ob.reshape(PB // PT, PT, T, D))
    return gb.reshape(PB, T, Np)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_geometry(name, pc, s):
    PT, T, D = pc.shape
    _shape(name, s, (PT, T, 1), "s")
    return PT, T, D


def _check_fwd(g, pc, s):
    name = "hat_eval"
    PT, T, D = _check_geometry(name, pc, s)
    PB, _, Np = g.shape
    _check(name, dict(g=g, pc=pc, s=s), g.device, torch.float32)
    _batches(name, PB, PT)
    _shape(name, g, (PB, T, Np), "g")
    return PB, PT, T, D, Np


def _check_t(ob, pc, s, Np):
    name = "hat_eval_t"
    PT, T, D = _check_geometry(name, pc, s)
    PB = ob.shape[0]
    _check(name, dict(ob=ob, pc=pc, s=s), ob.device, torch.float32)
    _batches(name, PB, PT)
    _shape(name, ob, (PB, T, D), "ob")
    if _row_smem(D, Np) > _MAX_SMEM:
        raise ValueError(f"{name}: a row of D={D} detectors and Np={Np} "
                         f"profile points needs {_row_smem(D, Np)} bytes of "
                         f"shared memory, above the kernel's {_MAX_SMEM}")
    return PB, PT, T, D


_FWD = _launch.Entry("hat_eval", "dip_hat_fwd", "hat_eval")
_T = _launch.Entry("hat_eval", "dip_hat_t", "hat_eval_t")
_fwd_checks = _launch.Checked(_check_fwd)
_t_checks = _launch.Checked(_check_t)


def hat_eval(g, pc, s):
    """K17: see :func:`hat_eval_ref`. The kernel reads the two taps that
    carry weight."""
    if _on_cpu(g):
        return hat_eval_ref(g, pc, s)
    PB, PT, T, D, Np = _fwd_checks(g, pc, s)
    out = g.new_empty((PB, T, D))
    _FWD(g.data_ptr(), pc.data_ptr(), s.data_ptr(), out.data_ptr(), PB, PT,
         T, D, Np, _stream())
    hat_eval.launches += 1
    return out


def hat_eval_t(ob, pc, s, Np: int):
    """K18: see :func:`hat_eval_t_ref`. ``Np`` is the profile length (the
    JAX entry reads it off a marker array)."""
    if _on_cpu(ob):
        return hat_eval_t_ref(ob, pc, s, Np)
    PB, PT, T, D = _t_checks(ob, pc, s, Np)
    gbar = ob.new_empty((PB, T, Np))
    _T(ob.data_ptr(), pc.data_ptr(), s.data_ptr(), gbar.data_ptr(), PB, PT,
       T, D, Np, _stream())
    hat_eval_t.launches += 1
    return gbar


launch_counts, reset_launch_counts = _launch.counters(hat_eval, hat_eval_t)
