"""Configuration dataclasses, field for field those of ``dip_admm_tpu.config``.

They are copied rather than imported: importing the JAX package loads JAX,
which the GPU host does not have. A test holds names, defaults and
frozen-ness equal to the JAX package's.

Canonical defaults mirror the reference flagship run: N=64, P=5 nodes,
lam_tv=0.02, rho=2.0, max_iters=200, eps_pri=eps_dual=1e-3, noise 0.005,
knn k=2, seed 123, q_mode="arithmetic".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    """Acquisition geometry: image on [-1,1]^2 with N x N pixels,
    ``angles_total = max(180, 3N)`` split evenly over nodes (remainder to
    the first nodes), a detector of N cells spanning
    ``det_width_factor * 2.0``. Parallel beam: angles uniform on [0, pi).
    Fan beam (``fan_beam``): source angles uniform on [0, 2 pi), source at
    ``src_radius`` and a flat detector at ``det_radius`` from the centre."""

    N: int = 64
    num_nodes: int = 5
    angles_total: Optional[int] = None  # default: max(180, 3N)
    det_pixels: Optional[int] = None  # default: N
    det_width_factor: float = 1.0
    fan_beam: bool = False
    src_radius: float = 4.0
    det_radius: float = 4.0

    @property
    def n(self) -> int:
        return self.N * self.N

    @property
    def total_angles(self) -> int:
        if self.angles_total is not None:
            return self.angles_total
        return max(180, 3 * self.N)

    @property
    def n_det(self) -> int:
        return self.det_pixels if self.det_pixels is not None else self.N

    def angles_per_node(self) -> Tuple[int, ...]:
        """Even split with remainder to the first nodes."""
        base = self.total_angles // self.num_nodes
        rem = self.total_angles % self.num_nodes
        return tuple(base + (1 if i < rem else 0) for i in range(self.num_nodes))


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Per-pixel communication-graph construction."""

    strategy: str = "knn"  # "knn" | "mst" | "chain" | "complete"
    k: int = 2
    seed: int = 123
    q_mode: str = "arithmetic"  # "arithmetic" | "harmonic"


@dataclasses.dataclass(frozen=True)
class NodeSolverConfig:
    """Inexact node-subproblem solver.

    The node update minimizes
        0.5||A_i x - b_i||^2 + lam_tv*TV(x) + (rho/2) sum_j ||x - v_ij||^2_{Q_ij}
    by Condat-Vu, checking the stationarity residual every ``check_every``
    iterations against eps_k = eps0 / (k+1)^(1+gamma_decay) until every
    node meets it, the residual plateaus, or ``max_inner`` iterations ran.
    """

    max_inner: int = 200
    check_every: int = 10
    # "cv" (plain steps), "fcv" (steps in a circulant Fourier metric with
    # a Lanczos-certified scale), "pcv" (per-pixel Jacobi steps), "ppdhg"
    # (diagonally preconditioned PDHG) or "fista" (accelerated proximal
    # gradient with a Chambolle TV prox of fista_prox_iters steps).
    algorithm: str = "cv"
    fista_prox_iters: int = 8
    eps0: float = 2.0
    gamma_decay: float = 0.005
    sigma_scale: float = 1.0  # dual step scale relative to default
    warm_start: bool = True
    # Early exit when no node's ||g|| improves by this relative amount
    # between checks. 0 disables.
    plateau_tol: float = 0.01
    # eps_k = max(eps0, eps_rel * ||A_i^T b_i||) / (k+1)^(1+gamma) per node.
    # 0 disables (reference-parity default).
    eps_rel: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Outer consensus-ADMM loop."""

    lam_tv: float = 0.02
    rho: float = 2.0
    max_iters: int = 200
    eps_pri: float = 1e-3
    eps_dual: float = 1e-3
    # Edge fusion: "midpoint" (a_i + a_j)/2, or "weighted" by the column
    # norms W, (W_i a_i + W_j a_j)/(W_i + W_j).
    z_fusion: str = "midpoint"
    # Over-relaxation: x^ = alpha*x + (1-alpha)*z in the z/y updates and
    # residuals (1.0 = the reference algorithm).
    relax_alpha: float = 1.0
    # Fused edge-consensus kernel K5 (the name is the JAX package's).
    # None (auto) = the CUDA kernel on a CUDA device with >= 8 graph nodes,
    # else the torch-op consensus; True = the kernel (its plain version for
    # CPU tensors); False = the torch-op consensus.
    use_pallas: Optional[bool] = None
    # Adapt rho after each outer by rho_tau (the scaled duals rescaled,
    # the scale clamped to [1/rho_clamp, rho_clamp]): "balance" when one
    # residual dominates the other by rho_mu, "stall" when the primal
    # residual fell by less than rho_stall_tol over rho_stall_window outers.
    adapt_rho: bool = False
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    rho_clamp: float = 64.0
    adapt_rho_mode: str = "balance"  # "balance" | "stall"
    rho_stall_window: int = 10
    rho_stall_tol: float = 0.02
    node: NodeSolverConfig = dataclasses.field(default_factory=NodeSolverConfig)


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Top-level experiment configuration."""

    geometry: GeometryConfig = dataclasses.field(default_factory=GeometryConfig)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    admm: AdmmConfig = dataclasses.field(default_factory=AdmmConfig)
    noise_level: float = 0.005
    noise_seed: int = 0
    phantom: str = "const"  # "const" | "rand" | "shepp"
    dtype: str = "float32"
    # Storage dtype of the projector tables ("float32" | "bfloat16").
    fft_table_dtype: str = "float32"
