"""Isotropic total-variation operators on [..., N, N] tensors.

``grad(x) -> (gx, gy)`` with
  gx[i, j] = x[i+1, j] - x[i, j]  (last row zero)
  gy[i, j] = x[i, j+1] - x[i, j]  (last column zero)

``grad_adjoint`` is the exact adjoint of ``grad``; ``||K||^2 <= 8`` bounds
the primal-dual step sizes. ``tv_prox_chambolle`` is the prox of the
weighted TV by dual ascent (fista's prox step); ``edge_map`` is |Kx| per pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dip_admm_tpu_torch.utils import profiling

GRAD_OPNORM_SQ = 8.0  # classical bound for the forward-difference 2-D gradient


def grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-difference gradient of [..., N, N] -> two [..., N, N] fields."""
    gx = F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))
    gy = F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))
    return gx, gy


def grad_adjoint(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(K^T p)[a, b] = p_x[a-1, b] - p_x[a, b] + p_y[a, b-1] - p_y[a, b],
    out-of-range entries zero; the structurally-zero last row of p_x and
    last column of p_y are ignored."""
    px = gx[..., :-1, :]
    py = gy[..., :, :-1]
    out = F.pad(px, (0, 0, 1, 0)) - F.pad(px, (0, 0, 0, 1))
    return out + F.pad(py, (1, 0)) - F.pad(py, (0, 1))


def tv_value(x: torch.Tensor) -> torch.Tensor:
    """Isotropic TV: sum over pixels of sqrt(gx^2 + gy^2)."""
    gx, gy = grad(x)
    return torch.sum(torch.sqrt(gx**2 + gy**2), dim=(-2, -1))


def tv_subgradient(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """K^T (Kx / |Kx|), zero where |Kx| <= eps: the normalized-field
    subgradient of the stationarity acceptance test."""
    gx, gy = grad(x)
    mag = torch.sqrt(gx**2 + gy**2)
    scale = torch.where(mag > eps, 1.0 / torch.clamp(mag, min=eps), 0.0)
    return grad_adjoint(gx * scale, gy * scale)


def project_l2_ball(
    gx: torch.Tensor, gy: torch.Tensor, radius: float | torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel projection of the dual field onto {|(px,py)|_2 <= radius}
    (the prox of the conjugate of ``radius * ||.||_{2,1}``). ``radius == 0``
    projects to zero."""
    mag = torch.sqrt(gx**2 + gy**2)
    if isinstance(radius, torch.Tensor):
        r = torch.as_tensor(radius, dtype=mag.dtype, device=mag.device)
    else:  # a host scalar's copy to a card waits for its queue
        profiling.count("sync")
        with profiling.span("sync", site="tv.radius"):
            r = torch.as_tensor(radius, dtype=mag.dtype, device=mag.device)
    safe_r = torch.clamp(r, min=1e-30)
    factor = torch.where(r > 0, 1.0 / torch.clamp(mag / safe_r, min=1.0), 0.0)
    return gx * factor, gy * factor


def tv_prox_chambolle(
    w: torch.Tensor,
    weight: float | torch.Tensor,
    n_iters: int = 20,
    step: float = 0.25,
    p_init: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """prox_{weight * TV}(w) by Chambolle's projected dual ascent.

    Solves argmin_x 0.5 ||x - w||^2 + weight * TV(x) through its dual,
    iterating p <- Proj_{|.| <= weight}(p + step * K(w - K^T p)), then
    x = w - K^T p. ``weight`` is a scalar or broadcasts against w (a
    per-node [P, 1, 1]); ``p_init`` warm-starts the dual field. Returns
    (x, (px, py)) so the caller can warm-start the next call."""
    if p_init is None:
        px, py = torch.zeros_like(w), torch.zeros_like(w)
    else:
        px, py = p_init
    for _ in range(n_iters):
        gx, gy = grad(w - grad_adjoint(px, py))
        px, py = project_l2_ball(px + step * gx, py + step * gy, weight)
    return w - grad_adjoint(px, py), (px, py)


def edge_map(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel gradient magnitude |Kx| of [..., N, N] (a diagnostic
    image)."""
    gx, gy = grad(x)
    return torch.sqrt(gx**2 + gy**2)
