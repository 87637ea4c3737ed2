"""Penalized-consensus solver with PDHG inner iterations: the legacy
standalone solver of the reference (``ADMM_Tomo_Only.py``), a different
algorithm family from edge-split ADMM. It has no duals; each outer
iteration

  1. forms per-pixel aggregation weights eta_pj and the convex-combination
     anchor x_a = sum_i normalized(eta) x_i, with eta = sqrt(W) / |x_i -
     x_true| ("oracle", the reference's checked-in weighting) or sqrt(W) /
     ||A_i x_i - b_i|| ("residual", its commented-out variant);
  2. runs ``node_pdhg_iters`` PDHG steps per node on
       gamma ||x - x_a||^2 + lam_tv (||A_i x - b_i||^2 + ||grad x||_{2,1})
     (the reference scales the whole of g_i, data term included, by
     lam_tv, and so does this);
  3. runs ``agg_pdhg_iters`` PDHG steps on the aggregate problem
       ||A x - b||^2 + lam_agg ||grad x||_{2,1};
  4. records the image and sinogram errors of both.

lam_tv decays as lam_tv exp(alpha_tv k). The steps are 1/||K_i|| with
||K_i||^2 = ||A_i^T A_i + grad^T grad|| from 25 power steps (and the same
for the aggregate). The nodes run as one batched PDHG; the loop runs on the
host with no device sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dip_admm_tpu_torch.data.loader import Problem
from dip_admm_tpu_torch.ops import tv


@dataclasses.dataclass(frozen=True)
class PdhgConsensusConfig:
    n_outer: int = 100  # the reference's niter
    lam_tv: float = 0.005  # its lambda_penalty
    lam_agg: float = 0.005  # its lambda_agg
    gamma: float = 2.0  # the quadratic consensus penalty
    node_pdhg_iters: int = 5
    agg_pdhg_iters: int = 15
    alpha_tv: float = 0.0  # the lambda decay exponent
    anchor_weights: str = "oracle"  # "oracle" | "residual"


class PdhgConsensusResult(NamedTuple):
    x_nodes: torch.Tensor  # [P, n]
    x_agg: torch.Tensor  # [n]
    img_mse_nodes: torch.Tensor  # [T, P] mean squared image error
    sino_mse_nodes: torch.Tensor  # [T, P] residual norms
    img_mse_agg: torch.Tensor  # [T]
    sino_mse_agg: torch.Tensor  # [T]


def _prox_conj_l2sq_translated(v, b, sigma, lam):
    """prox_{sigma h*} for h(z) = lam ||z - b||^2 (no 1/2, ODL's
    L2NormSquared): u = (v - sigma b) / (1 + sigma / (2 lam))."""
    return (v - sigma * b) / (1.0 + sigma / (2.0 * lam))


def _grad_t(x, N):
    """grad^T grad x for x [..., n]."""
    gx, gy = tv.grad(x.reshape(x.shape[:-1] + (N, N)))
    return tv.grad_adjoint(gx, gy).reshape(x.shape)


def solve(problem: Problem, cfg: PdhgConsensusConfig | None = None,
          node_v0: torch.Tensor | None = None,
          agg_v0: torch.Tensor | None = None) -> PdhgConsensusResult:
    """Run the solver on ``problem``'s nodes. ``node_v0`` [P, n] and
    ``agg_v0`` [n] start the power methods of the node and aggregate step
    sizes; the JAX package draws them with ``PRNGKey(11)`` and
    ``PRNGKey(12)``, which torch cannot reproduce, so a caller that must
    match it passes its draws (default: normal draws from generators seeded
    with 11 and 12)."""
    cfg = cfg or PdhgConsensusConfig()
    if cfg.anchor_weights not in ("oracle", "residual"):
        raise ValueError("anchor_weights must be 'oracle' or 'residual'")
    P, n, N = problem.num_nodes, problem.n, problem.N
    dev, dtype = problem.device, problem.b.dtype
    fwd, adj = problem.forward, problem.adjoint
    b, x_true = problem.b, problem.x_true
    W_cols = torch.sqrt(problem.W)  # the column norms

    def draw(v0, seed, shape):
        if v0 is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            v0 = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return torch.as_tensor(v0, dtype=dtype, device=dev)

    # ||K_i|| for K_i = [A_i; grad]: sqrt(||A_i^T A_i + grad^T grad||).
    v = draw(node_v0, 11, (P, n))
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    lam = torch.ones((P,), dtype=dtype, device=dev)
    for _ in range(25):
        w = adj(fwd(v)) + _grad_t(v, N)
        lam = torch.linalg.norm(w, dim=1)
        v = w / torch.clamp(lam[:, None], min=1e-30)
    tau_n = (1.0 / torch.sqrt(lam))[:, None]
    sig_n = tau_n

    def fwd_all(x):  # one image [n] through every node's operator
        return fwd(x[None].expand(P, n))

    # ||K_agg|| for K_agg = [A_1; ..; A_P; grad].
    va = draw(agg_v0, 12, (n,))
    va = va / torch.linalg.norm(va)
    lam_a = torch.ones((), dtype=dtype, device=dev)
    for _ in range(25):
        wa = torch.sum(adj(fwd_all(va)), dim=0) + _grad_t(va, N)
        lam_a = torch.linalg.norm(wa)
        va = wa / torch.clamp(lam_a, min=1e-30)
    tau_a = sig_a = 1.0 / torch.sqrt(lam_a)

    def node_pdhg(x, ya, yg, x_a, lam_tv):
        """Batched PDHG on gamma||x - x_a||^2 + lam (||Ax - b||^2 +
        ||Gx||_21)."""
        xb = x
        for _ in range(cfg.node_pdhg_iters):
            ya = _prox_conj_l2sq_translated(ya + sig_n * fwd(xb), b, sig_n,
                                            lam_tv)
            gx, gy = tv.grad(xb.reshape(P, N, N))
            sg = sig_n[..., None]
            yg = tv.project_l2_ball(yg[0] + sg * gx, yg[1] + sg * gy, lam_tv)
            kty = adj(ya) + tv.grad_adjoint(*yg).reshape(P, n)
            w = x - tau_n * kty
            x_new = (w + 2.0 * tau_n * cfg.gamma * x_a) / (
                1.0 + 2.0 * tau_n * cfg.gamma)
            xb = 2.0 * x_new - x
            x = x_new
        return x, ya, yg

    def agg_pdhg(x, ya, yg):
        """PDHG on sum_i ||A_i x - b_i||^2 + lam_agg ||Gx||_21 (f = 0)."""
        xb = x
        for _ in range(cfg.agg_pdhg_iters):
            ya = _prox_conj_l2sq_translated(ya + sig_a * fwd_all(xb), b,
                                            sig_a, 1.0)
            gx, gy = tv.grad(xb.reshape(N, N))
            yg = tv.project_l2_ball(yg[0] + sig_a * gx, yg[1] + sig_a * gy,
                                    cfg.lam_agg)
            kty = torch.sum(adj(ya), dim=0) + tv.grad_adjoint(*yg).reshape(n)
            x_new = x - tau_a * kty
            xb = 2.0 * x_new - x
            x = x_new
        return x, ya, yg

    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    x, ya, yg = z(P, n), z(P, b.shape[1]), (z(P, N, N), z(P, N, N))
    x_agg, ya_a, yg_a = z(n), z(P, b.shape[1]), (z(N, N), z(N, N))
    T = cfg.n_outer
    h_img, h_sino, h_ai, h_as = z(T, P), z(T, P), z(T), z(T)
    for k in range(T):
        lam_tv = cfg.lam_tv * torch.exp(torch.tensor(
            cfg.alpha_tv * k, dtype=dtype, device=dev))
        if cfg.anchor_weights == "oracle":
            eta = W_cols / (torch.abs(x - x_true[None, :]) + 1e-8)
        else:
            err = torch.linalg.norm(fwd(x) - b, dim=1, keepdim=True)
            eta = W_cols / (err + 1e-8)
        eta = eta / (torch.sum(eta, dim=0, keepdim=True) + 1e-8)
        x_a = torch.sum(eta * x, dim=0)[None, :].expand(P, n)

        x, ya, yg = node_pdhg(x, ya, yg, x_a, lam_tv)
        x_agg, ya_a, yg_a = agg_pdhg(x_agg, ya_a, yg_a)

        h_img[k] = torch.mean((x - x_true[None, :]) ** 2, dim=1)
        h_sino[k] = torch.linalg.norm(fwd(x) - b, dim=1)
        h_ai[k] = torch.mean((x_agg - x_true) ** 2)
        h_as[k] = torch.linalg.norm((fwd_all(x_agg) - b).reshape(-1))
    return PdhgConsensusResult(x_nodes=x, x_agg=x_agg, img_mse_nodes=h_img,
                               sino_mse_nodes=h_sino, img_mse_agg=h_ai,
                               sino_mse_agg=h_as)
