"""Problem construction for projector modes ``dense``, ``joseph``,
``fft``, ``fft_skew`` and ``fft_grouped``, in parallel and fan beam, and
``fft_shear``, ``fft_pallas`` and ``fft_mxu``, in parallel beam.

A :class:`Problem` carries the per-node angle sets, the noisy sinograms
``b_i = A_i x_i + sigma * eps`` (zero on padded angle rows; x_i is the
shared phantom, or node i's own with ``per_node_phantoms``), the exact
column norms W, the per-pixel graph (Q, keep, adj), the power-method
operator norms and the projector tables, all on one device. Measurements
are angle-major: row r = angle * n_det + det. The tables of ``dense`` are
the padded operator stack ``{"A": [P, m_max * D, n]}``, those of
``joseph`` its tap tables (``ops/radon.py``); every per-node table has the
node count leading, so a mesh rank's node slice needs no code of its own.

Random draws (the measurement noise, the power-method start and the chain
graph's node orders) come from ``torch.Generator``s seeded from the config;
callers that must match another implementation pass them in explicitly
(``noise``, ``opnorm_v0``, ``orders``).

``cfg.dtype`` is the JAX package's problem dtype, with its per-field
result (JAX without x64): "float64" builds in float32; under "bfloat16" or
"float16" the angles, phantom, W, Q, x_true and opnorm take that dtype,
the tables are built in float32 from the rounded angles, and b (and with
it the loop state) takes the dtype the mode's projector returns for an
image of that dtype (:data:`_KEEPS_DTYPE`); mode ``fft`` refuses it, as
there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dip_admm_tpu_torch.config import GeometryConfig, ProblemConfig
from dip_admm_tpu_torch.graph import precisions, topology
from dip_admm_tpu_torch.ops import phantoms, radon, radon_fan, radon_fft
from dip_admm_tpu_torch.utils import profiling

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# cfg.dtype -> the problem's dtype (float64 is float32, as under JAX
# without x64).
_PROBLEM_DTYPES = {"float32": torch.float32, "float64": torch.float32,
                  "bfloat16": torch.bfloat16, "float16": torch.float16}
MODES = ("dense", "joseph", "fft", "fft_skew", "fft_grouped", "fft_pallas",
         "fft_shear", "fft_mxu")
# The largest N at which mode=None picks "dense" (the JAX loader's rule).
DENSE_MAX_N = 128
# (forward, adjoint) of each ported mode, by fan_beam.
_OPS = {
    **{("dense", fan): (radon.project_nodes_dense,
                        radon.backproject_nodes_dense)
       for fan in (False, True)},
    **{("joseph", fan): (radon.project_nodes, radon.backproject_nodes)
       for fan in (False, True)},
    ("fft", False): (radon_fft.project_nodes_phases,
                     radon_fft.backproject_nodes_phases),
    ("fft", True): (radon_fan.project_nodes_fan,
                    radon_fan.backproject_nodes_fan),
    ("fft_skew", False): (radon_fft.project_nodes_skew,
                          radon_fft.backproject_nodes_skew),
    ("fft_skew", True): (radon_fan.project_nodes_fan_skew,
                         radon_fan.backproject_nodes_fan_skew),
    ("fft_grouped", False): (radon_fft.project_nodes_grouped,
                             radon_fft.backproject_nodes_grouped),
    ("fft_grouped", True): (radon_fan.project_nodes_fan_grouped,
                            radon_fan.backproject_nodes_fan_grouped),
    ("fft_pallas", False): (radon_fft.project_nodes_merged,
                            radon_fft.backproject_nodes_merged),
    ("fft_shear", False): (radon_fft.project_nodes_shear,
                           radon_fft.backproject_nodes_shear),
    ("fft_mxu", False): (radon_fft.project_nodes_mxu,
                         radon_fft.backproject_nodes_mxu),
}
# The (mode, fan_beam) whose JAX projector returns a half-precision image's
# projection in that dtype; the others return float32.
_KEEPS_DTYPE = {("fft_skew", False), ("fft_skew", True), ("fft_shear", False),
                ("fft_grouped", True)}


@dataclasses.dataclass
class Problem:
    """All device-resident problem data."""

    cfg: ProblemConfig
    mode: str
    angles: torch.Tensor  # [P, m_max]
    angle_valid: torch.Tensor  # [P, m_max] bool
    b: torch.Tensor  # [P, m_max * D] flattened noisy sinograms
    W: torch.Tensor  # [P, n] column-norm weights
    Q: torch.Tensor  # [P, P, n] per-pixel masked precisions
    keep: torch.Tensor  # [P, P, n] bool per-pixel masks
    adj: torch.Tensor  # [P, P] bool union adjacency
    x_true: torch.Tensor  # [n]
    opnorm: torch.Tensor  # [P] estimates of ||A_i^T A_i||_2
    fft_tables: dict
    # (i0, i1) on a rank that holds only the node block [i0, i1) of the
    # per-node arrays and tables (parallel.multihost.distribute_problem).
    node_block: Optional[tuple[int, int]] = None

    @property
    def num_nodes(self) -> int:
        return self.cfg.geometry.num_nodes

    @property
    def N(self) -> int:
        return self.cfg.geometry.N

    @property
    def n(self) -> int:
        return self.cfg.geometry.n

    @property
    def m_flat(self) -> int:
        return self.b.shape[1]

    @property
    def device(self) -> torch.device:
        return self.b.device

    @property
    def A(self) -> Optional[torch.Tensor]:
        """The dense operator stack [P, m_max * D, n] (mode "dense")."""
        return self.fft_tables.get("A") if self.mode == "dense" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[P, n] images -> [P, m_max * D] measurements."""
        return make_node_ops(self.mode, self.cfg.geometry, self.fft_tables)[0](x)

    def adjoint(self, r: torch.Tensor) -> torch.Tensor:
        """[P, m_max * D] residuals -> [P, n] backprojections."""
        return make_node_ops(self.mode, self.cfg.geometry, self.fft_tables)[1](r)


def _check_mode(mode: str, geo: GeometryConfig) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown projector mode {mode!r} (one of {MODES})")
    if (mode, geo.fan_beam) not in _OPS:
        raise NotImplementedError(f"{mode} supports parallel beam only")


def make_node_ops(mode: str, geo: GeometryConfig, tables: dict):
    """Batched per-node (forward, adjoint) callables on flattened data.

    The projectors, and the kernels in them, take float32: a half-precision
    input is cast to float32 here, and the result to the dtype the JAX
    package's projector returns for it (its own for ``_KEEPS_DTYPE``, else
    float32). A float32 input passes through uncast."""
    _check_mode(mode, geo)
    project, backproject = _OPS[mode, geo.fan_beam]
    N, D = geo.N, geo.n_det
    keeps = (mode, geo.fan_beam) in _KEEPS_DTYPE

    def out_dtype(x):
        return x.dtype if keeps else torch.promote_types(x.dtype,
                                                         torch.float32)

    def fwd(x):
        profiling.count("proj.fwd")
        with profiling.span("proj.fwd"):
            return project(geo, x.reshape(-1, N, N).to(torch.float32),
                           tables).reshape(x.shape[0], -1).to(out_dtype(x))

    def adj(r):
        profiling.count("proj.adj")
        with profiling.span("proj.adj"):
            return backproject(
                geo, r.reshape(r.shape[0], -1, D).to(torch.float32), tables
            ).reshape(r.shape[0], -1).to(out_dtype(r))

    return fwd, adj


def resolve_mode(geo: GeometryConfig, mode: Optional[str] = None,
                 dense: Optional[bool] = None) -> str:
    """The projector mode ``build_problem`` uses (the JAX loader's rule):
    an explicit ``mode`` wins; else ``dense=True/False`` means "dense" /
    "joseph"; else "dense" at N <= 128 and "fft_skew" above, parallel and
    fan beam alike."""
    if mode is not None:
        return mode
    if dense is not None:
        return "dense" if dense else "joseph"
    return "dense" if geo.N <= DENSE_MAX_N else "fft_skew"


def build_tables(cfg: ProblemConfig, angles, valid, mode: str,
                 row_block: Optional[int] = None) -> dict:
    """The projector tables of any ported mode: the dense stack ``A``,
    the Joseph tap tables, or :func:`build_fft_tables`'s."""
    geo = cfg.geometry
    _check_mode(mode, geo)
    if mode == "dense":
        P, m = angles.shape
        A = torch.empty((P, m * geo.n_det, geo.n), dtype=torch.float32,
                        device=angles.device)
        for i in range(P):
            radon.dense_matrix(geo, angles[i], valid[i], out=A[i])
        return {"A": A}
    if mode == "joseph":
        return radon.joseph_tables(geo, angles, valid)
    return build_fft_tables(cfg, angles, valid, mode, row_block)


def build_fft_tables(cfg: ProblemConfig, angles, valid,
                     mode: str = "fft_skew",
                     row_block: Optional[int] = None) -> dict:
    """Projector tables in ``cfg.fft_table_dtype``. Fan beam shares one
    parallel-stage table set among the nodes (``ops/radon_fan.py``).
    ``row_block`` overrides the row-block size nb (default 128) of the
    ``fft_skew``/``fft_shear`` factorization: the pixel axis of a mesh
    shards the skew tables along their NB = N / nb row blocks, so smaller
    blocks admit more pixel shards."""
    geo = cfg.geometry
    _check_mode(mode, geo)
    tdt = _DTYPES[cfg.fft_table_dtype]
    nb = {} if row_block is None else {"nb": row_block}
    if geo.fan_beam:
        if mode == "fft_skew":
            return radon_fan.precompute_fan_skew(geo, angles, valid, tdt, **nb)
        if mode == "fft":
            return radon_fan.precompute_fan_nodes(geo, angles, valid, tdt)
        return radon_fan.precompute_fan_grouped(geo, angles, valid, tdt)
    if mode == "fft":
        return radon_fft.precompute_phases_nodes(geo, angles, valid, tdt)
    if mode in ("fft_skew", "fft_shear"):
        return radon_fft.precompute_shear(
            geo, angles, valid, tdt, layout=mode.removeprefix("fft_"), **nb)
    if mode == "fft_pallas":  # H pitched for K11/K12's 16-byte streams
        return radon_fft.precompute_merged_nodes(geo, angles, valid, tdt,
                                                 pitched=True)
    pre = {"fft_grouped": radon_fft.precompute_grouped,
           "fft_mxu": radon_fft.precompute_merged_mxu}[mode]
    return pre(geo, angles, valid, tdt)


def node_colnorms(geo: GeometryConfig, angles, valid, mode: str = "fft_skew",
                  tables: Optional[dict] = None) -> torch.Tensor:
    """W[i, p] = ||A_i[:, p]||^2 of the operator in use, floored at EPS:
    the squared rows of A summed (``dense``), the Joseph taps' squared
    transpose applied to ones (``joseph``), or the fft modes' exact norms
    (every fft mode applies the same operator). ``tables`` are the mode's
    (:func:`build_tables`), which dense and joseph read."""
    if mode == "dense":
        A = tables["A"]
        W = torch.stack([torch.sum(A[i] * A[i], dim=0)
                         for i in range(A.shape[0])])
    elif mode == "joseph":
        W = radon.colnorms_sq_nodes(tables)
    elif geo.fan_beam:
        W = radon_fan.colnorms_sq_nodes(geo, angles, valid)
    else:
        W = torch.stack([
            radon_fft.colnorms_sq(geo, angles[i], valid[i])
            for i in range(angles.shape[0])
        ])
    return torch.clamp(W.reshape(W.shape[0], -1), min=precisions.EPS)


def build_graph_layer(W, q_mode: str, strategy: str, k: int,
                      seed: int = 123, orders=None):
    """Pairwise precisions, per-pixel masks and the union adjacency.
    ``seed`` and ``orders`` are the chain graph's
    (``topology.build_pixel_masks``)."""
    q_full = precisions.pairwise_q(W, q_mode)
    keep = topology.build_pixel_masks(q_full, strategy=strategy, k=k,
                                      seed=seed, orders=orders)
    Q = q_full * keep
    adj = topology.union_adjacency(keep)
    return Q, keep, adj


def rebuild_graph(problem: Problem, graph_cfg, orders=None) -> Problem:
    """The same problem (operators, data, W) with the per-pixel graph of
    ``graph_cfg``: a new ``cfg.graph``, Q, keep and adj. ``orders`` are the
    chain's node orders, as in :func:`build_problem`."""
    cfg = dataclasses.replace(problem.cfg, graph=graph_cfg)
    Q, keep, adj = build_graph_layer(problem.W, graph_cfg.q_mode,
                                     graph_cfg.strategy, graph_cfg.k,
                                     graph_cfg.seed, orders)
    return dataclasses.replace(problem, cfg=cfg, Q=Q, keep=keep, adj=adj)


def estimate_opnorms(fwd, adj, P: int, n: int, device, iters: int = 30,
                     v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched power-method estimates of ||A_i^T A_i||. ``v0`` [P, n] is the
    start (default: a normal draw from a generator seeded with 7)."""
    if v0 is None:
        gen = torch.Generator(device=device).manual_seed(7)
        v0 = torch.randn((P, n), generator=gen, device=device)
    v = v0.to(device=device, dtype=torch.float32)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    lam = torch.zeros(P, device=device)
    for _ in range(iters):
        w = adj(fwd(v))
        lam = torch.linalg.norm(w, dim=1)
        v = w / torch.clamp(lam[:, None], min=1e-30)
    return lam


def build_problem(
    cfg: ProblemConfig,
    device: torch.device | str,
    mode: Optional[str] = None,
    noise: Optional[torch.Tensor] = None,
    opnorm_v0: Optional[torch.Tensor] = None,
    row_block: Optional[int] = None,
    dense: Optional[bool] = None,
    phantom_array=None,
    per_node_phantoms: bool = False,
    orders: Optional[torch.Tensor] = None,
) -> Problem:
    """Assemble a :class:`Problem` on ``device``.

    ``mode`` is "dense", "joseph", "fft", "fft_skew", "fft_grouped" or
    (parallel beam only) "fft_shear", "fft_pallas" or "fft_mxu";
    ``mode=None`` follows
    the JAX loader's rule (:func:`resolve_mode`): "dense" at N <= 128 and
    "fft_skew" above, parallel and fan beam alike, and ``dense=True/False``
    is an alias for "dense"/"joseph". ``noise`` [P, m] replaces the
    standard-normal draw (a generator seeded with ``cfg.noise_seed``);
    ``opnorm_v0`` [P, n] replaces the power-method start. ``row_block``
    is :func:`build_fft_tables`'s.

    Each node measures its own image: by default every node the phantom
    ``cfg.phantom``; with ``per_node_phantoms`` node i a random phantom
    (``phantoms.rand_im(N, seed=cfg.noise_seed + i)``, numpy-seeded as in
    the JAX package); ``phantom_array`` is one [N, N] array for every node
    or a list of P. ``x_true`` is node 0's image. ``orders`` [n, P] are the
    chain graph's node orders (``topology.build_pixel_masks``).
    ``cfg.dtype``: see the module docstring."""
    device = torch.device(device)
    geo = cfg.geometry
    mode = resolve_mode(geo, mode, dense)
    _check_mode(mode, geo)
    if cfg.dtype not in _PROBLEM_DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} is not one of "
                         f"{tuple(_PROBLEM_DTYPES)}")
    dtype = _PROBLEM_DTYPES[cfg.dtype]
    if mode == "fft" and dtype != torch.float32:
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{cfg.dtype}")
    N, P, D, n = geo.N, geo.num_nodes, geo.n_det, geo.n
    if isinstance(phantom_array, (list, tuple)) and len(phantom_array) != P:
        raise ValueError(f"phantom_array: {len(phantom_array)} images "
                         f"for {P} nodes")

    with profiling.span("loader.build_problem", mode=mode, N=N, P=P):
        with profiling.span("loader.phantoms"):
            angles_np, valid_np, _ = radon.node_angles(geo)
            angles = torch.as_tensor(angles_np, dtype=dtype, device=device)
            valid = torch.as_tensor(valid_np, device=device)
            if isinstance(phantom_array, (list, tuple)):
                node_phantoms = list(phantom_array)
            elif phantom_array is not None:
                node_phantoms = [phantom_array] * P
            elif per_node_phantoms:
                node_phantoms = [phantoms.rand_im(N, seed=cfg.noise_seed + i)
                                 for i in range(P)]
            else:
                node_phantoms = [phantoms.make_phantom(
                    cfg.phantom, N, seed=cfg.noise_seed)] * P
            imgs = torch.stack([torch.as_tensor(np.asarray(ph), dtype=dtype)
                                .reshape(-1) for ph in node_phantoms]
                               ).to(device)
            x_true = imgs[0].clone()

        with profiling.span("loader.tables"):
            # The geometry in float32, from the angles as the problem
            # holds them.
            angles32 = angles.to(torch.float32)
            tables = build_tables(cfg, angles32, valid, mode, row_block)
        fwd, adj = make_node_ops(mode, geo, tables)

        with profiling.span("loader.data"):
            clean = fwd(imgs)
            del imgs
            if noise is None:
                gen = torch.Generator(device=device).manual_seed(
                    cfg.noise_seed)
                noise = torch.randn(clean.shape, generator=gen, device=device)
            row_valid = valid.repeat_interleave(D, dim=1).to(dtype)
            b = clean + (cfg.noise_level * noise.to(device, clean.dtype)
                         * row_valid)

        with profiling.span("loader.colnorms"):
            W = node_colnorms(geo, angles32, valid, mode, tables).to(dtype)
        with profiling.span("loader.graph"):
            g = cfg.graph
            Q, keep, adjm = build_graph_layer(W, g.q_mode, g.strategy, g.k,
                                              g.seed, orders)
        with profiling.span("loader.opnorms"):
            opnorm = estimate_opnorms(fwd, adj, P, n, device,
                                      v0=opnorm_v0).to(dtype)
    return Problem(
        cfg=cfg, mode=mode, angles=angles, angle_valid=valid, b=b, W=W, Q=Q,
        keep=keep, adj=adjm, x_true=x_true, opnorm=opnorm, fft_tables=tables,
    )
