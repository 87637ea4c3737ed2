"""The Condat-Vu inner step of the node solver as two CUDA kernels, with the
plain composition they replace.

One step of ``core/node_solver.py``'s cv, fcv and pcv (P node images of
N x N pixels, x [P, n], the TV duals ux, uy [P, N, N]):

    d   = adj_out + rho (D x - b_cons) + K^T u      adj_out = A^T(A x - b)
    x+  = x - s * precond(d)
    u+  = Proj_{|.| <= lam}(u + sig K (2 x+ - x))

``precond`` is the metric (cv and pcv: none; fcv: M^-1, two FFTs), ``s``
the step (cv: tau [P, 1]; fcv: tk [P, 1]; pcv: T [P, n]), ``sig`` the dual
step ([P, 1, 1]; pcv: [P, N, N]). ``rho`` and ``lam`` are Python floats,
0-d tensors or one a node ([P, 1] and [P, 1, 1]).

On a CUDA device :func:`step` launches ``dip_cv_grad`` (d) and
``dip_cv_update`` (x+, u+) of ``csrc/cv_step.cu`` around ``precond``,
through the lean launch path of ``_launch.py``, and counts
``node.fused_steps``; the kernels give the plain composition's bits in
float32, float64 and bfloat16, the dtype of the state (x, ux, uy). A field
or operand in a narrower dtype (a bfloat16 D_vec beside a float32 state)
enters as torch's promotion takes it, widened exactly. On the card it
takes every step the node solver makes, and raises on what it cannot give
the plain bits of (another dtype, an input wider than the state, which
would promote the result); on the CPU it is :func:`step_ref`, the
composition itself, unchanged. The
kernels read rho, s, sig and lam on the card or as host values, so the
fused step copies no host scalar to the card (the plain one copies a host
``lam`` in ``tv.project_l2_ball``). Each output is a new tensor.

``step.launches`` counts the fused steps (two launches each);
``launch_counts`` and ``reset_launch_counts`` read and clear it.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops import tv
from dip_admm_tpu_torch.ops.kernels import _launch
from dip_admm_tpu_torch.ops.kernels.shear_sum import _stream
from dip_admm_tpu_torch.utils import profiling

# The kernels' dtype codes.
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def step_ref(x, ux, uy, adj_out, D_vec, b_cons, rho, precond, s, sig, lam):
    """One Condat-Vu step in plain torch ops: (x+, ux+, uy+)."""
    P, N = ux.shape[0], ux.shape[-1]
    ktu = tv.grad_adjoint(ux, uy).reshape(P, -1)
    x_new = x - s * precond(adj_out + rho * (D_vec * x - b_cons) + ktu)
    gx, gy = tv.grad((2.0 * x_new - x).reshape(P, N, N))
    ux, uy = tv.project_l2_ball(ux + sig * gx, uy + sig * gy, lam)
    return x_new, ux, uy


def _operand(name, v, x, per_pixel):
    """Operand ``name`` as the kernels read it against the fields (``x``'s
    dtype and device): (tensor or None, host value, stride), the stride 0
    (one value), 1 (one a node) or 2 (one a pixel, where ``per_pixel``).

    A host value (a Python number or a 0-d CPU tensor, which torch reads as
    a host scalar) goes as it is; the kernels convert it as torch does. A
    tensor goes in the fields' dtype. The radius is cast to the fields'
    dtype wherever it comes from, as ``tv.project_l2_ball`` casts it; any
    other operand with dimensions must widen into the fields' dtype, since
    in the plain step a wider one would promote the result."""
    dtype = x.dtype
    if isinstance(v, torch.Tensor) and v.dim() == 0 and not v.is_cuda:
        v = v.item()
    if not isinstance(v, torch.Tensor):
        if name == "lam" and dtype == torch.bfloat16:
            v = torch.tensor(v, dtype=dtype).item()
        return None, float(v), 0
    if v.device != x.device:
        raise ValueError(f"cv_step: {name} is on {v.device}, expected "
                         f"{x.device}")
    if (v.dim() > 0 and name != "lam"
            and torch.promote_types(v.dtype, dtype) != dtype):
        raise ValueError(f"cv_step: {name} is {v.dtype}, the fields "
                         f"{dtype}")
    P, n = x.shape
    k = v.numel()
    if k == 1:
        stride = 0
    elif v.shape[0] == P and k == P:
        stride = 1
    elif per_pixel and v.shape[0] == P and k == P * n:
        stride = 2
    else:
        raise ValueError(f"cv_step: {name} has shape {tuple(v.shape)}; "
                         f"expected one value, one a node [{P}, ...]"
                         + (f" or one a pixel [{P}, {n}]" if per_pixel
                            else ""))
    return v.to(dtype).contiguous().reshape(-1), 0.0, stride


def _ptr(op):
    t, v, stride = op
    return (None if t is None else t.data_ptr()), v, stride


def _check_step(x, ux, uy, adj_out, D_vec, b_cons):
    """The tensor checks of the fused step: (P, N, the dtype's code). The
    state (x, ux, uy) sets the dtype; adj_out, D_vec and b_cons may be
    narrower (each meets x first in the plain step, which widens it)."""
    name = "cv_step"
    P, N = ux.shape[0], ux.shape[-1]
    shapes = dict(x=(P, N * N), ux=(P, N, N), uy=(P, N, N),
                  adj_out=(P, N * N), D_vec=(P, N * N), b_cons=(P, N * N))
    tensors = dict(x=x, ux=ux, uy=uy, adj_out=adj_out, D_vec=D_vec,
                   b_cons=b_cons)
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: the fields are {x.dtype}; the kernels "
                         "take float32, float64 or bfloat16")
    for k, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {k} is on {t.device}, "
                             f"expected {x.device}")
        if (t.dtype != x.dtype if k in ("ux", "uy") else
                torch.promote_types(t.dtype, x.dtype) != x.dtype):
            raise ValueError(f"{name}: {k} is {t.dtype}, expected "
                             f"{x.dtype}")
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return P, N, DTYPES[x.dtype]


_checks = _launch.Checked(_check_step)
_GRAD = _launch.Entry("cv_step", "dip_cv_grad", "cv_step")
_UPDATE = _launch.Entry("cv_step", "dip_cv_update", "cv_step")


def step(x, ux, uy, adj_out, D_vec, b_cons, rho, precond, s, sig, lam):
    """One Condat-Vu step (see the module docstring): (x+, ux+, uy+)."""
    if not x.is_cuda:
        return step_ref(x, ux, uy, adj_out, D_vec, b_cons, rho, precond, s,
                        sig, lam)
    x, ux, uy, adj_out, D_vec, b_cons = (
        t.contiguous() for t in (x, ux, uy, adj_out, D_vec, b_cons))
    P, N, code = _checks(x, ux, uy, adj_out, D_vec, b_cons)
    adj_out, D_vec, b_cons = (t.to(x.dtype) for t in (adj_out, D_vec,
                                                       b_cons))
    rho_o = _operand("rho", rho, x, False)
    s_o = _operand("s", s, x, True)
    sig_o = _operand("sig", sig, x, True)
    lam_o = _operand("lam", lam, x, False)
    d = torch.empty_like(x)
    _GRAD(adj_out.data_ptr(), x.data_ptr(), D_vec.data_ptr(),
          b_cons.data_ptr(), ux.data_ptr(), uy.data_ptr(), *_ptr(rho_o),
          d.data_ptr(), P, N, code, _stream())
    y = precond(d)
    if y.dtype != x.dtype or y.shape != x.shape or y.device != x.device:
        raise ValueError(f"cv_step: the metric's output is {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}, expected "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    y = y.contiguous()
    x_new = torch.empty_like(x)
    ux_new, uy_new = torch.empty_like(ux), torch.empty_like(uy)
    _UPDATE(x.data_ptr(), y.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            *_ptr(s_o), *_ptr(sig_o), *_ptr(lam_o), x_new.data_ptr(),
            ux_new.data_ptr(), uy_new.data_ptr(), P, N, code, _stream())
    step.launches += 1
    profiling.count("node.fused_steps")
    return x_new, ux_new, uy_new


step.launches = 0


def launch_counts() -> dict:
    return {"cv_step": step.launches}


def reset_launch_counts() -> None:
    step.launches = 0
