"""Centralized aggregate baselines, on all nodes' measurements stacked:

- ridge least squares, x = (A^T A + lam I)^-1 A^T b (Cholesky on the
  stacked dense operator, CG on the normal equations for the matrix-free
  modes);
- TV-regularized least squares, min 0.5||A x - b||^2 + lam_tv TV(x), the
  quality ceiling of the decentralized runs: the batched node solver with
  one node, rho = 0 and no consensus coupling (``cv``, or ``fcv`` with its
  preconditioner).
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.config import NodeSolverConfig
from dip_admm_tpu_torch.core import node_solver
from dip_admm_tpu_torch.data.loader import Problem
from dip_admm_tpu_torch.ops import linalg


def aggregate_ops(problem: Problem):
    """(fwd, adj, b) of the stacked operator: x [1, n] broadcast to every
    node's forward, the residuals concatenated ([1, P * m]); the adjoint
    sums the nodes' backprojections."""
    P = problem.num_nodes

    def fwd(x):
        return problem.forward(x.expand(P, x.shape[-1])).reshape(1, -1)

    def adj(r):
        return torch.sum(problem.adjoint(r.reshape(P, -1)), dim=0,
                         keepdim=True)

    return fwd, adj, problem.b.reshape(1, -1)


def ridge_reconstruction(problem: Problem, lam: float = 1e-3) -> torch.Tensor:
    """x [n] = (A^T A + lam I)^-1 A^T b on the aggregate operator: Cholesky
    of the Gram of the stacked dense A (mode "dense"), else CG on the
    normal equations (500 iterations at most, tolerance 1e-8)."""
    if problem.mode != "dense":
        fwd, adj, b = aggregate_ops(problem)

        def mv(x):
            return adj(fwd(x[None]))[0] + lam * x

        x, _, _ = linalg.cg(mv, adj(b)[0], max_iters=500, tol=1e-8)
        return x
    return linalg.ridge_solve(problem.A.reshape(-1, problem.n),
                              problem.b.reshape(-1), lam)


def tv_reconstruction(
    problem: Problem,
    lam_tv: float = 0.02,
    cfg: NodeSolverConfig | None = None,
    eps: float = 1e-3,
    lanczos_v0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """min_x 0.5||A x - b||^2 + lam_tv TV(x) on the aggregate operator,
    by ``solve_nodes`` with P = 1 (default: cv, 2000 iterations checked
    every 50, stationarity target ``eps``). Returns (x [n], the final
    stationarity norm). ``lanczos_v0`` [n] is fcv's Lanczos start
    (``node_solver.build_fourier_precond``)."""
    cfg = cfg or NodeSolverConfig(max_inner=2000, check_every=50)
    fwd, adj, b = aggregate_ops(problem)
    n, N = problem.n, problem.N
    dev, dtype = problem.device, problem.b.dtype
    # ||sum_i A_i^T A_i|| <= sum_i ||A_i^T A_i||
    L = torch.sum(problem.opnorm)[None]
    zeros = torch.zeros((1, n), dtype=dtype, device=dev)
    fprecond = None
    if cfg.algorithm == "fcv":
        fprecond = node_solver.build_fourier_precond(fwd, adj, zeros, 0.0,
                                                     cfg, N, v0=lanczos_v0)
    res = node_solver.solve_nodes(
        fwd, adj, b, zeros, zeros, torch.zeros((1,), dtype=dtype, device=dev),
        lam_tv, 0.0, L, node_solver.init_state(1, N, b.shape[1], dev, dtype),
        torch.tensor(eps, dtype=dtype, device=dev), cfg, N,
        fprecond=fprecond,
    )
    return res.state.x[0], res.g_norm[0]
