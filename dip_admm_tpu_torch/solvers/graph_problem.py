"""A declarative node/edge-objective graph optimization API, the shape of
the reference's SnapVX demo (``Decentral_WQ_admm.py``: a ``TGraphVX`` with
``AddNode(i, 0.5||A_i x - b_i||^2 + 0.5 x^T W_i x)``,
``AddEdge(i, j, 0.5 (x_i - x_j)^T Q (x_i - x_j))`` and
``Solve(UseADMM=True)``), lowered onto the consensus-ADMM runtime:
quadratic/least-squares node objectives with optional TV, diagonal
quadratic edge objectives.

The edge objectives are soft penalties, not consensus constraints. Edge
splitting introduces copies z_ij = (z_i, z_j) with x_i = z_i, x_j = z_j;
for 0.5 (z_i - z_j)^T diag(q) (z_i - z_j) the edge minimization has the
per-pixel closed form

    z_i = (a_i + a_j)/2 + rho/(2q + rho) * (a_i - a_j)/2,   a_i = x_i + y_i,

a damped midpoint that becomes exact consensus as q -> inf. This fusion is
not K5's function (the JAX package computes it with XLA ops too), so it
stays plain torch. The node problems are the batched node solver's, on the
stacked operator [A; sqrt(diag)].

    gp = GraphProblem(n_side=8, device="cuda")
    for i in range(P):
        gp.add_node(A=A_i, b=b_i, diag_quad=w_i)
    gp.add_edge(0, 1, q_diag)
    x, history = gp.solve(rho=1.0, max_iters=50)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dip_admm_tpu_torch.config import NodeSolverConfig
from dip_admm_tpu_torch.core import node_solver


@dataclasses.dataclass
class _Node:
    A: Optional[np.ndarray]  # [m_i, n] (None for a matrix-free problem)
    b: np.ndarray  # [m_i]
    diag_quad: Optional[np.ndarray]  # [n]: + 0.5 x^T diag(w) x
    lam_tv: float


class GraphProblem:
    """A graph optimization problem built node by node, edge by edge, on
    ``device``.

    ``operators=(fwd, adj, opnorms)`` makes the node data terms a batched
    matrix-free measurement operator family (fwd: [P, n] -> [P, m], adj its
    exact adjoint, opnorms [P] bounds on ||A_i^T A_i||), e.g. a problem's
    ``forward``/``adjoint``/``opnorm``; ``add_node`` then takes only the
    node's data ``b`` (with the diagonal and TV terms)."""

    def __init__(self, n_side: int, operators=None,
                 device: torch.device | str = "cuda"):
        self.N = n_side
        self.n = n_side * n_side
        self.device = torch.device(device)
        self._nodes: list[_Node] = []
        self._edges: dict[tuple[int, int], np.ndarray] = {}
        self._ops = operators

    def add_node(self, A=None, b=None, diag_quad=None,
                 lam_tv: float = 0.0) -> int:
        """Node objective 0.5||A x - b||^2 + 0.5 x^T diag(w) x + lam_tv
        TV(x); with ``operators`` set, omit ``A``. Returns the node's
        index."""
        if b is None:
            raise ValueError("add_node needs the node's data b")
        b = _np(b)
        if self._ops is None:
            if A is None:
                raise ValueError("add_node needs A (or the problem's "
                                 "operators)")
            A = _np(A)
            if A.shape != (b.shape[0], self.n):
                raise ValueError(f"A has shape {A.shape}, expected "
                                 f"({b.shape[0]}, {self.n})")
        elif A is not None:
            raise ValueError("a matrix-free GraphProblem's nodes take only b")
        diag = None if diag_quad is None else _np(diag_quad)
        self._nodes.append(_Node(A, b, diag, float(lam_tv)))
        return len(self._nodes) - 1

    def add_edge(self, i: int, j: int, q_diag=1.0) -> None:
        """Edge objective 0.5 (x_i - x_j)^T diag(q) (x_i - x_j)."""
        q = np.broadcast_to(_np(q_diag), (self.n,))
        self._edges[(min(i, j), max(i, j))] = q

    def solve(self, rho: float = 1.0, max_iters: int = 50,
              eps_pri: float = 1e-6, eps_dual: float = 1e-6,
              inner: NodeSolverConfig | None = None,
              lanczos_v0: torch.Tensor | None = None):
        """Consensus ADMM (the demo's ``Solve(UseADMM=True, MaxIters=50,
        Rho=1.0)``). Returns (x [P, n] on the device, history: "primal",
        "dual" and "objective" [max_iters] as numpy, NaN past the last
        outer). ``lanczos_v0`` is fcv's Lanczos start
        (``node_solver.build_fourier_precond``)."""
        P = len(self._nodes)
        if P == 0:
            raise ValueError("no nodes declared")
        n, N, dev = self.n, self.N, self.device
        f32 = torch.float32
        inner = inner or NodeSolverConfig(max_inner=200, check_every=25)

        m_max = max(nd.b.shape[0] for nd in self._nodes)
        b = np.zeros((P, m_max), np.float32)
        diag = np.zeros((P, n), np.float32)
        lam = np.zeros((P,), np.float32)
        for i, nd in enumerate(self._nodes):
            b[i, :nd.b.shape[0]] = nd.b
            lam[i] = nd.lam_tv
            if nd.diag_quad is not None:
                diag[i] = nd.diag_quad
        Q = np.zeros((P, P, n), np.float32)
        adjm = np.zeros((P, P), np.float32)
        for (i, j), q in self._edges.items():
            Q[i, j] = Q[j, i] = q
            adjm[i, j] = adjm[j, i] = 1.0
        t = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731

        if self._ops is None:
            A = torch.zeros((P, m_max, n), dtype=f32, device=dev)
            for i, nd in enumerate(self._nodes):
                A[i, :nd.A.shape[0]] = t(nd.A)
            # ||A_i^T A_i||_2, the largest eigenvalue of the Gram
            gram_norm = torch.linalg.eigvalsh(A.transpose(1, 2) @ A)[:, -1]

            def base_fwd(x):
                return torch.bmm(A, x[:, :, None])[:, :, 0]

            def base_adj(r):
                return torch.bmm(A.transpose(1, 2), r[:, :, None])[:, :, 0]
        else:
            base_fwd, base_adj, opn = self._ops
            gram_norm = t(opn)
        x, hist = _solve(base_fwd, base_adj, t(b), t(diag), t(Q), t(adjm),
                         t(lam), gram_norm, rho, eps_pri, eps_dual, N,
                         max_iters, inner, lanczos_v0)
        return x, {k: v.cpu().numpy() for k, v in hist.items()}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _solve(base_fwd, base_adj, b, diag, Q, adjm, lam, gram_norm, rho,
           eps_pri, eps_dual, N, max_iters, inner_cfg, lanczos_v0):
    """Soft-edge consensus ADMM: the node solves on the stacked operator
    [A; sqrt(diag)], the damped midpoint fusion, one host sync per outer
    (the stop test) besides the node solver's."""
    P, n = diag.shape
    m_max = b.shape[1]
    dev, dtype = b.device, b.dtype
    # The diagonal quadratic rides along as sqrt(diag) rows under the
    # measurement operator, so one fwd/adj pair serves the smooth part.
    sq = torch.sqrt(diag)

    def fwd(x):
        return torch.cat([base_fwd(x), sq * x], dim=1)

    def adj(r):
        return base_adj(r[:, :m_max]) + sq * r[:, m_max:]

    b_full = torch.cat([b, torch.zeros((P, n), dtype=dtype, device=dev)],
                       dim=1)
    # Lipschitz bound: ||A^T A|| + max(diag) + rho * degree (the copy
    # constraints add rho I per incident edge), and the node penalty metric
    # D = degree through the solver's D/b_cons interface.
    degree = torch.sum(adjm, dim=1)
    L = gram_norm + torch.amax(diag, dim=1) + rho * degree
    D_vec = degree[:, None].expand(P, n)
    damp = rho / (2.0 * Q + rho) * adjm[:, :, None]
    am = adjm[:, :, None]
    fprecond = None
    if inner_cfg.algorithm == "fcv":
        fprecond = node_solver.build_fourier_precond(
            fwd, adj, D_vec, rho, inner_cfg, N, v0=lanczos_v0)

    st = node_solver.init_state(P, N, b_full.shape[1], dev, dtype)
    Z = torch.zeros((P, P, n), dtype=dtype, device=dev)
    Y = torch.zeros_like(Z)
    hist = {k: torch.full((max_iters,), float("nan"), dtype=dtype,
                          device=dev)
            for k in ("primal", "dual", "objective")}
    k = 0
    while k < max_iters:
        V = (Z - Y) * am
        b_cons = torch.sum(V, dim=1)
        c_quad = torch.sum(V * V, dim=(1, 2))
        eps_k = torch.tensor(1e-3, dtype=dtype, device=dev) / (k + 1.0)
        res = node_solver.solve_nodes(
            fwd, adj, b_full, D_vec, b_cons, c_quad, lam, rho, L, st, eps_k,
            inner_cfg, N, fprecond=fprecond)
        st = res.state
        X = st.x
        A_prop = X[:, None, :] + Y
        A_T = A_prop.transpose(0, 1)
        mid = 0.5 * (A_prop + A_T)
        Zn = (mid + 0.5 * damp * (A_prop - A_T)) * am
        Y = (Y + X[:, None, :] - Zn) * am
        dpri = (X[:, None, :] - Zn) * am
        pri = torch.sqrt(torch.sum(dpri * dpri))
        dz = (Zn - Z) * am
        dual = torch.sqrt(rho**2 * torch.sum(dz * dz))
        Z = Zn
        hist["primal"][k] = pri
        hist["dual"][k] = dual
        hist["objective"][k] = torch.sum(res.objective)
        k += 1
        if bool((pri < eps_pri) & (dual < eps_dual)):  # the outer's sync
            break
    return st.x, hist
