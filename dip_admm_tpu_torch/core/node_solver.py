"""Inexact node-subproblem solver: batched Condat-Vu primal-dual iteration.

The subproblem at node i and outer iteration k is

    min_x  0.5 ||A_i x - b_i||^2 + lam_tv * TV(x)
           + (rho/2) sum_j ||x - v_ij||^2_{Q_ij}

split as f(x) + h(Kx): f = smooth LS + diagonal quadratic (gradient
A^T(Ax-b) + rho*(D x - b_cons) with D = sum_j Q_ij, b_cons = sum_j Q_ij v_ij),
h = lam_tv * ||.||_{2,1}, K = the forward-difference gradient. Condat-Vu:

    x+ = x - tau * (grad f(x) + K^T u)
    u+ = Proj_{|.| <= lam_tv} (u + sigma * K (2 x+ - x))

All P node problems run as one batched iteration. Every ``check_every``
steps the stationarity residual
    g = A^T(Ax - b) + rho*(D x - b_cons) + lam_tv * K^T(Kx/|Kx|)
is checked against the target eps_k; the loop stops when every node meets
it, when no node improved by ``plateau_tol`` since the last check, or at
``max_inner``. Loop control runs on the host: one device sync per check.
Nodes that meet the target keep iterating until all finish.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dip_admm_tpu_torch.config import NodeSolverConfig
from dip_admm_tpu_torch.ops import tv


class NodeState(NamedTuple):
    """Warm-started inner-solver state (per node, batched). ``ua``, ``xp``
    and ``tk`` belong to the algorithms not ported yet; ``cv`` carries them
    unchanged so the state matches the JAX package's field for field."""

    x: torch.Tensor  # [P, n]
    ux: torch.Tensor  # [P, N, N] TV dual, x-component
    uy: torch.Tensor  # [P, N, N] TV dual, y-component
    ua: torch.Tensor  # [P, m]
    xp: torch.Tensor  # [P, n]
    tk: torch.Tensor  # [P]


class NodeSolveResult(NamedTuple):
    state: NodeState
    g_norm: torch.Tensor  # [P] final stationarity residual norms
    objective: torch.Tensor  # [P] node objective values
    # [P] iterations to first acceptance (check_every granularity); nodes
    # that never met the target record the full trip count.
    inner_iters: torch.Tensor
    trip_count: int  # iterations the batched solve executed
    # [P] 0 = accepted at eps_k, 1 = plateau exit before the budget,
    # 2 = ran the full inner budget without meeting the target.
    accept_code: torch.Tensor


def init_state(P: int, N: int, m: int, device, dtype=torch.float32) -> NodeState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return NodeState(
        x=z(P, N * N), ux=z(P, N, N), uy=z(P, N, N), ua=z(P, m),
        xp=z(P, N * N),
        tk=torch.full((P,), float("inf"), dtype=dtype, device=device),
    )


def solve_nodes(
    fwd: Callable[[torch.Tensor], torch.Tensor],
    adj: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,  # [P, m]
    D_vec: torch.Tensor,  # [P, n] = sum_j Q_ij (masked)
    b_cons: torch.Tensor,  # [P, n] = sum_j Q_ij v_ij
    c_quad: torch.Tensor,  # [P] = sum_{j,p} Q_ij v_ij^2 (objective constant)
    lam_tv: float,
    rho: float,
    L: torch.Tensor,  # [P] Lipschitz bounds ||A^T A|| + rho*max(D)
    state: NodeState,
    eps_k: torch.Tensor,  # scalar or [P] adaptive stationarity target
    cfg: NodeSolverConfig,
    N: int,
) -> NodeSolveResult:
    if cfg.algorithm != "cv":
        raise NotImplementedError(
            f"inner algorithm {cfg.algorithm!r} is not ported yet (only 'cv')"
        )
    P = b.shape[0]
    dtype = state.x.dtype
    dev = state.x.device
    lam = float(lam_tv)

    def grad_f(x):
        return adj(fwd(x) - b) + rho * (D_vec * x - b_cons)

    def g_residual(x):
        sub = tv.tv_subgradient(x.reshape(P, N, N)).reshape(P, -1)
        return grad_f(x) + lam * sub

    # Balanced steps: sigma*||K||^2 = L/2 => tau = 0.99/(L/2 + sigma*||K||^2).
    Ksq = tv.GRAD_OPNORM_SQ
    sigma = (cfg.sigma_scale * L / (2.0 * Ksq)).to(dtype)
    tau = (0.99 / (L / 2.0 + sigma * Ksq)).to(dtype)
    tau_c = tau[:, None]
    sig_im = sigma[:, None, None]

    x, ux, uy = state.x, state.ux, state.uy
    k = 0
    g_prev = torch.full((P,), float("inf"), dtype=dtype, device=dev)
    g_norm = g_prev
    acc = torch.full((P,), -1, dtype=torch.int32, device=dev)
    active = True
    while k < cfg.max_inner and active:
        for _ in range(cfg.check_every):
            ktu = tv.grad_adjoint(ux, uy).reshape(P, -1)
            x_new = x - tau_c * (grad_f(x) + ktu)
            gx, gy = tv.grad((2.0 * x_new - x).reshape(P, N, N))
            ux, uy = tv.project_l2_ball(ux + sig_im * gx, uy + sig_im * gy,
                                        lam)
            x = x_new
        g_norm = torch.linalg.norm(g_residual(x), dim=1)
        acc = torch.where((acc < 0) & (g_norm <= eps_k),
                          k + cfg.check_every, acc).to(torch.int32)
        unmet = torch.any(g_norm > eps_k)
        if cfg.plateau_tol > 0:
            improving = torch.any(torch.where(
                torch.isinf(g_prev), True,
                (g_prev - g_norm) > cfg.plateau_tol * torch.abs(g_prev),
            ))
            unmet = unmet & improving
        active = bool(unmet)  # the one host sync per check
        g_prev = g_norm
        k += cfg.check_every
    if k == 0:  # the loop never ran: compute the residual once
        g_norm = torch.linalg.norm(g_residual(x), dim=1)

    inner_per_node = torch.where(acc >= 0, acc, k)
    r = fwd(x) - b
    data_term = 0.5 * torch.sum(r * r, dim=1)
    tv_term = lam * tv.tv_value(x.reshape(P, N, N))
    quad = 0.5 * rho * (
        torch.sum(D_vec * x**2, dim=1) - 2.0 * torch.sum(b_cons * x, dim=1)
        + c_quad
    )
    accept_code = torch.where(
        acc >= 0, 0, 1 if k < cfg.max_inner else 2
    ).to(torch.int32)
    st = state._replace(x=x, ux=ux, uy=uy)
    return NodeSolveResult(st, g_norm, data_term + tv_term + quad,
                           inner_per_node, k, accept_code)
