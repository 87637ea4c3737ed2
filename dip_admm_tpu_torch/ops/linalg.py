"""Linear-algebra primitives of the alternative solvers: conjugate gradients
for SPD normal equations, a power method for operator norms, and a direct
Cholesky path for small (Gram-mode) problems.

The JAX package runs CG inside a ``lax.while_loop`` whose predicate stops
it early; here the loop runs on the host. An iterate whose residual met the
tolerance is frozen on the device (``torch.where``), so the iterations
counted are exactly those the JAX loop executes, and the host reads the
stop flag only every ``_CG_CHECK_EVERY`` iterations.
"""

from __future__ import annotations

from typing import Callable

import torch

# CG's host reads the stop flag once per this many iterations: one device
# sync per block of iterations, not per iteration; the frozen iterate makes
# the extra iterations of a block no-ops.
_CG_CHECK_EVERY = 10


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.reshape(-1), v.reshape(-1))


def cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    max_iters: int = 50,
    tol: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conjugate gradients for an SPD ``matvec``: at most ``max_iters``
    iterations, stopping once ||r||^2 <= tol^2 * max(||b||^2, 1e-30).
    Returns (x, the final ||r||^2, the iterations run) as tensors."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = _dot(r, r)
    thresh = (tol**2) * torch.clamp(_dot(b, b), min=1e-30)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for it in range(max_iters):
        if it % _CG_CHECK_EVERY == 0 and not bool(rs > thresh):
            break  # every later iteration would be frozen
        live = rs > thresh
        ap = matvec(p)
        denom = _dot(p, ap)
        alpha = rs / torch.where(denom > 0, denom, 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * ap
        rs_n = _dot(r_n, r_n)
        beta = rs_n / torch.where(rs > 0, rs, 1e-30)
        p_n = r_n + beta * p
        x = torch.where(live, x_n, x)
        r = torch.where(live, r_n, r)
        p = torch.where(live, p_n, p)
        rs = torch.where(live, rs_n, rs)
        k = k + live.to(torch.int32)
    return x, rs, k


def power_method(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    shape: tuple[int, ...],
    iters: int = 30,
    v0: torch.Tensor | None = None,
    seed: int = 0,
    device: torch.device | str = "cuda",
    dtype=torch.float32,
) -> torch.Tensor:
    """Largest eigenvalue of a symmetric PSD operator (e.g. A^T A) by
    ``iters`` power steps from ``v0`` (default: a normal draw of ``shape``
    from a generator seeded with ``seed``; the JAX package draws it with
    ``jax.random``, which torch cannot reproduce, so a caller that must
    match it passes its draw)."""
    if v0 is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        v0 = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    v = v0 / torch.linalg.norm(v0)
    lam = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = matvec(v)
        lam = torch.linalg.norm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def solve_spd(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Direct SPD solve by Cholesky; ``rhs`` [n] or [n, k]."""
    chol = torch.linalg.cholesky(mat)
    vec = rhs.dim() == 1
    out = torch.cholesky_solve(rhs[:, None] if vec else rhs, chol)
    return out[:, 0] if vec else out


def ridge_solve(A: torch.Tensor, b: torch.Tensor, lam: float) -> torch.Tensor:
    """x = (A^T A + lam I)^-1 A^T b: the aggregate ridge baseline, with the
    Gram formed and factored in float64 and x returned in A's dtype.

    At a small lam the Gram's condition reaches ~3e4 (the aggregate CT
    operator, lam = 1e-3), and a float32 Cholesky solve is then off by up
    to cond x eps of x's scale, by the order of its sums: on the CPU the
    thread count moved the port's PSNR by 0.2 dB. In float64 the solve is
    exact to float32 rounding, whatever the order."""
    A64 = A.to(torch.float64)
    n = A.shape[1]
    gram = A64.T @ A64 + lam * torch.eye(n, dtype=A64.dtype, device=A.device)
    return solve_spd(gram, A64.T @ b.to(torch.float64)).to(A.dtype)
