"""Consensus ADMM on a node x pixel mesh of ``torch.distributed`` ranks.

The port of the JAX package's ``parallel/admm_sharded.py``. Each rank of a
``parallel.mesh.Mesh`` holds its node block of the data (P_loc = P /
n_node nodes: sinograms, Lipschitz bounds, per-node tables), the
[P_loc, P, n_loc] edge state Z, Y, Q over its pixel block (n_loc = n /
pixel), and runs the shared iteration body ``core.admm.admm_iteration``
with collective ``CommOps``:

  - the edge fusion needs a_ji, which lies on the rank of node j: one
    all_to_all over the node axis transposes the pair grid (the minimal
    neighbour exchange, P_loc * P * n_loc values per rank);
  - residual norms and totals are all-reduced, so every rank computes the
    same stop flag and the outer loops stay in step; the node solver ORs
    its continue flag across the ranks, so the inner trip counts match;
  - node solves see full images: the pixel blocks of D and b_cons are
    all-gathered before them, and the new iterate is sliced after.

Pixel compute (the JAX package's rule): with a pixel axis, ``fft_skew``
tables (parallel or fan) whose row-block count NB the pixel axis divides
also split along NB, and each pixel shard applies only its row blocks
through the row-sharded skew pair (``radon_fft.RowShard``): K1 on its rows,
one pixel-axis sum of the slot spectra, K6 on its rows, one pixel-axis
all-gather. Otherwise (``dense`` and ``joseph`` among them: node slices
of A or of the tap tables) node solves run replicated along the pixel
axis.

Every rank passes the whole problem (built or loaded identically on each)
and slices it, or its own node block of it
(``parallel.multihost.distribute_problem``). States and histories in and
out are this rank's blocks, and resume as ``run_admm``'s do;
:func:`gather_result` assembles whole arrays and :func:`take_blocks` cuts
them again (a checkpoint resumed on a mesh).
"""

from __future__ import annotations

from typing import Optional

import torch

from dip_admm_tpu_torch.config import AdmmConfig
from dip_admm_tpu_torch.core import admm, node_solver
from dip_admm_tpu_torch.core.admm import (
    AdmmResult, AdmmState, CommOps, NodeBlockData,
)
from dip_admm_tpu_torch.data.loader import Problem, make_node_ops
from dip_admm_tpu_torch.ops import radon_fan, radon_fft
from dip_admm_tpu_torch.parallel.mesh import (
    NODE_AXIS, PIXEL_AXIS, Mesh, shards_for, slice_tables,
)


def _blocks(problem: Problem, mesh: Mesh) -> tuple[slice, slice]:
    """This rank's node slice of [P] and pixel slice of [n]."""
    P_loc = shards_for(problem.num_nodes, mesh)
    n = problem.n
    if n % mesh.pixel:
        raise ValueError(f"n={n} must be divisible by the pixel axis "
                         f"{mesh.pixel}")
    n_loc = n // mesh.pixel
    i0, p0 = mesh.node_index * P_loc, mesh.pixel_index * n_loc
    return slice(i0, i0 + P_loc), slice(p0, p0 + n_loc)


def _local(problem: Problem, nodes: slice) -> slice:
    """Where this rank's node block lies in the problem's per-node arrays:
    ``nodes`` in a whole problem, all of them in a distributed one (which
    must hold this block)."""
    if problem.node_block is None:
        return nodes
    if tuple(problem.node_block) != (nodes.start, nodes.stop):
        raise ValueError(f"the problem holds the node block "
                         f"{problem.node_block}, this rank runs "
                         f"({nodes.start}, {nodes.stop})")
    return slice(0, nodes.stop - nodes.start)


def pixel_compute(problem: Problem, mesh: Mesh) -> bool:
    """Whether the pixel axis splits the projector's row blocks:
    ``fft_skew`` tables (parallel, or the fan path's ``shared.par``) whose
    row-block count the pixel axis divides."""
    t = problem.fft_tables
    if problem.cfg.geometry.fan_beam:
        t = t.get("shared", {}).get("par", {})
    return (mesh.pixel > 1 and problem.mode == "fft_skew" and "WtT" in t
            and t["WtT"].shape[1] % mesh.pixel == 0)


def make_comm(mesh: Mesh, n_loc: int) -> CommOps:
    """The iteration body's collectives on ``mesh``."""
    p0 = mesh.pixel_index * n_loc

    def pair_transpose(A):
        # [i_loc, j, n] -> [i_loc, j, n] holding a_ji: the j-blocks of A
        # (A^T's rows) go to their node shards, and the blocks received
        # come back in node-shard order, i.e. along the global i.
        P_loc, P, n = A.shape
        t = mesh.all_to_all(A.transpose(0, 1).contiguous(), NODE_AXIS)
        return t.reshape(P // P_loc, P_loc, P_loc, n).transpose(0, 1) \
            .reshape(P_loc, P, n).contiguous()

    def any_reduce(v):
        # Over the whole mesh: the pixel replicas agree already, and a flag
        # every rank shares keeps every rank's collectives in step.
        return mesh.all_reduce(v.to(torch.int32), None, "max").bool()

    return CommOps(
        pair_transpose=pair_transpose,
        psum=lambda v: mesh.all_reduce(v, None),
        any_reduce=any_reduce,
        psum_repl=lambda v: mesh.all_reduce(v, NODE_AXIS),
        pmax_repl=lambda v: mesh.all_reduce(v, NODE_AXIS, "max"),
        psum_pixel=lambda v: mesh.all_reduce(v, PIXEL_AXIS),
        gather_pixels=lambda v: mesh.all_gather(v, PIXEL_AXIS, -1),
        my_pixels=lambda v: v if mesh.pixel == 1 else v[..., p0:p0 + n_loc],
    )


def row_shard(mesh: Mesh) -> radon_fft.RowShard:
    """This rank's pixel shard of the row-sharded skew projector."""
    return radon_fft.RowShard(
        index=mesh.pixel_index,
        psum=lambda t: mesh.all_reduce(t, PIXEL_AXIS),
        gather=lambda t, dim: mesh.all_gather(t, PIXEL_AXIS, dim))


def _node_ops(problem: Problem, mesh: Mesh, tables: dict, rowshard: bool):
    """This rank's batched (forward, adjoint) on flattened data."""
    geo = problem.cfg.geometry
    if not rowshard:
        return make_node_ops(problem.mode, geo, tables)
    N, D = geo.N, geo.n_det
    shard = row_shard(mesh)
    if geo.fan_beam:
        project = radon_fan.project_nodes_fan_skew_rowshard
        backproject = radon_fan.backproject_nodes_fan_skew_rowshard
    else:
        project = radon_fft.project_nodes_skew_rowshard
        backproject = radon_fft.backproject_nodes_skew_rowshard

    def fwd(x):
        return project(geo, x.reshape(-1, N, N), tables,
                       shard).reshape(x.shape[0], -1)

    def adj(r):
        return backproject(geo, r.reshape(r.shape[0], -1, D), tables,
                           shard).reshape(r.shape[0], -1)

    return fwd, adj


def block_data(problem: Problem, cfg: AdmmConfig, mesh: Mesh,
               lanczos_v0: Optional[torch.Tensor] = None
               ) -> tuple[NodeBlockData, CommOps]:
    """This rank's constants of a run (as ``core.admm.block_data`` builds
    them on one device) and the collectives that go with them."""
    nodes, pix = _blocks(problem, mesh)
    loc = _local(problem, nodes)
    comm = make_comm(mesh, pix.stop - pix.start)
    rowshard = pixel_compute(problem, mesh)
    held = problem.num_nodes if problem.node_block is None else loc.stop
    tables = slice_tables(problem.fft_tables, held, loc,
                          (mesh.pixel_index, mesh.pixel) if rowshard
                          else None)
    fwd, adj = _node_ops(problem, mesh, tables, rowshard)
    D_vec = torch.sum(problem.Q, dim=1)
    L = (problem.opnorm + cfg.rho * torch.amax(D_vec, dim=-1))[loc]
    b = problem.b[loc]
    Q = problem.Q[loc, :, pix].contiguous()
    g_scale = None
    if cfg.node.eps_rel > 0:
        g_scale = torch.linalg.norm(adj(b), dim=1)
    fprecond = None
    if cfg.node.algorithm == "fcv":
        # Each rank builds its node block's preconditioner through its own
        # operators (the JAX package's per-shard setup): node solves see
        # full images, so D's pixel blocks are gathered first.
        fprecond = node_solver.build_fourier_precond(
            fwd, adj, comm.gather_pixels(torch.sum(Q, dim=1)), cfg.rho,
            cfg.node, problem.N, v0=lanczos_v0,
        )
    W_all = (problem.W if problem.node_block is None
             else mesh.all_gather(problem.W, NODE_AXIS, 0))
    data = NodeBlockData(
        fwd=fwd, adj=adj, b=b, Q=Q, adjm=problem.adj[loc].to(b.dtype),
        W=problem.W[loc], L=L, x_true=problem.x_true, N=problem.N,
        g_scale=g_scale, fprecond=fprecond, W_all=W_all,
    )
    return data, comm


def init_state(problem: Problem, cfg: AdmmConfig,
               mesh: Mesh) -> tuple[AdmmState, dict]:
    """This rank's block of a fresh loop state, and its history buffers."""
    nodes, pix = _blocks(problem, mesh)
    P_loc, n_loc = nodes.stop - nodes.start, pix.stop - pix.start
    dtype, dev = problem.b.dtype, problem.device
    P = problem.num_nodes
    state = AdmmState(
        node=node_solver.init_state(P_loc, problem.N, problem.m_flat, dev,
                                    dtype),
        Z=torch.zeros((P_loc, P, n_loc), dtype=dtype, device=dev),
        Y=torch.zeros((P_loc, P, n_loc), dtype=dtype, device=dev),
        k=0, stop=False,
        rho_scale=torch.tensor(1.0, dtype=dtype, device=dev),
    )
    return state, admm.make_history(cfg.max_iters, P_loc, dev, dtype)


def run_admm_sharded(
    problem: Problem,
    cfg: Optional[AdmmConfig] = None,
    mesh: Optional[Mesh] = None,
    state: Optional[AdmmState] = None,
    hist: Optional[dict] = None,
    until: Optional[int] = None,
    lanczos_v0: Optional[torch.Tensor] = None,
) -> AdmmResult:
    """Consensus ADMM with the graph nodes sharded over ``mesh``'s node
    axis and the edge state over its pixel axis; every rank of the mesh
    calls it with the same problem and arguments.

    The resume contract of ``core.admm.run_admm``, on this rank's blocks:
    pass the ``state``/``hist`` of a previous (possibly partial) run to
    continue from ``state.k``; ``until`` caps this call's last outer
    iteration; ``hist`` is updated in place. The result holds this rank's
    blocks (x [P_loc, n], per-node history columns [P_loc]);
    :func:`gather_result` assembles them. ``lanczos_v0`` is ``run_admm``'s.
    Unknown option values raise as they do in ``run_admm``."""
    if mesh is None:
        raise ValueError("run_admm_sharded needs the mesh (make_mesh)")
    cfg = cfg if cfg is not None else problem.cfg.admm
    admm.check_config(cfg)
    if state is None:
        state, hist = init_state(problem, cfg, mesh)
    if hist is None:
        raise ValueError("run_admm_sharded: resuming needs the history with "
                         "the state")
    until = cfg.max_iters if until is None else min(until, cfg.max_iters)
    data, comm = block_data(problem, cfg, mesh, lanczos_v0)
    while state.k < until and not state.stop:
        state = admm.admm_iteration(data, cfg, state, hist, comm)
    return AdmmResult(x=state.node.x, history=hist, n_iters=state.k,
                      state=state)


def gather_result(res: AdmmResult, mesh: Mesh) -> AdmmResult:
    """``res`` of :func:`run_admm_sharded` with whole arrays, on every
    rank: x [P, n], the state (Z, Y [P, P, n]) and the history with every
    node's column."""
    def nodes(t):
        return mesh.all_gather(t, NODE_AXIS, 0)

    def edges(t):
        return mesh.all_gather(nodes(t), PIXEL_AXIS, 2)

    st = res.state
    node = type(st.node)(*(nodes(v) for v in st.node))
    state = st._replace(node=node, Z=edges(st.Z), Y=edges(st.Y))
    per_node = dict(admm.HISTORY_FIELDS)
    hist = {name: mesh.all_gather(v, NODE_AXIS, 1) if per_node[name] else v
            for name, v in res.history.items()}
    return AdmmResult(x=node.x, history=hist, n_iters=res.n_iters,
                      state=state)


def take_blocks(state: AdmmState, hist: dict, problem: Problem,
                mesh: Mesh) -> tuple[AdmmState, dict]:
    """This rank's blocks of a whole state and history (a checkpoint of
    either package, or :func:`gather_result`'s): its node block of x and
    of every node field, its node and pixel blocks of Z and Y, and its
    columns of the per-node history fields. The inverse of
    :func:`gather_result`."""
    nodes, pix = _blocks(problem, mesh)
    node = type(state.node)(*(v[nodes].contiguous() for v in state.node))
    st = state._replace(node=node, Z=state.Z[nodes, :, pix].contiguous(),
                        Y=state.Y[nodes, :, pix].contiguous())
    per_node = dict(admm.HISTORY_FIELDS)
    return st, {name: v[:, nodes].contiguous() if per_node[name] else v
                for name, v in hist.items()}
