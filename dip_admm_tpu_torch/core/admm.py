"""Decentralized edge-consensus ADMM on one device.

Update equations:
  node update  : argmin 0.5||A_i x - b_i||^2 + lam*TV + (rho/2)sum_j ||x-v_ij||^2_Q
                 with v_ij = z_ij - y_ij,i                        (eq. 1)
  edge fusion  : z_ij = (a_i + a_j) / 2 (midpoint) or
                 (W_i a_i + W_j a_j) / (W_i + W_j) (weighted),
                 a_i = x^_ij + y_ij,i, x^_ij = alpha x_i + (1-alpha) z_ij (eq. 2)
  dual update  : y_ij,i += x^_ij - z_ij                           (eq. 3)
  residuals    : r^2 = sum_edges ||x_i - z||^2 + ||x_j - z||^2,
                 s^2 = rho^2 sum_edges ||z+ - z||^2                (eqs. 4-5)
  stop         : pri < eps_pri and dual < eps_dual                 (eq. 6)

The per-pixel masks zero Q in the node subproblem; z/y/residual updates run
on full vectors over the union-graph edges. The loop runs on the host: one
device sync per outer iteration (the stop flag), besides the node solver's
one per acceptance check. The edge consensus is the fused kernel K5
(``ops/kernels/consensus.py``) or its plain torch version.

:func:`run_admm_batched` solves one operator and graph against a batch of
B sinogram sets at once (the JAX package's ``vmap`` of the whole run): the
B x P node problems run as one grouped node solve, the edge state carries a
leading batch axis through K5, and each scenario stops on its own residuals
and is frozen from then on.

The iteration body is written against ``CommOps``, as in the JAX package:
one implementation serves the single device (``LOCAL_COMM``, all
identities) and the node x pixel mesh of ``parallel/admm_sharded.py``,
where a rank holds the node block [P_loc] of the node-solve tensors, with
full images, and the [P_loc, P, n_loc] edge state (Z, Y, Q) over its pixel
block.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from dip_admm_tpu_torch.config import AdmmConfig
from dip_admm_tpu_torch.core import node_solver
from dip_admm_tpu_torch.core.node_solver import NodeState
from dip_admm_tpu_torch.data.loader import Problem
from dip_admm_tpu_torch.ops.kernels import consensus
from dip_admm_tpu_torch.utils import profiling


def _identity(v):
    return v


class CommOps(NamedTuple):
    """Collective hooks of the iteration body (the JAX package's
    ``core.admm.CommOps``).

    - ``pair_transpose``: [P_loc, P, n_loc] -> the value at the swapped
      (j, i) pair (an all_to_all over the node axis). None on one device,
      where the consensus update reads a_ji from its own input.
    - ``psum``: total of pixel-partial quantities (node and pixel axes).
    - ``any_reduce``: OR of a boolean tensor across the shards (the node
      solver's continue flag, so every shard runs the same inner trip).
    - ``psum_repl``: node-axis total of pixel-replicated quantities (the
      node-solve outputs).
    - ``pmax_repl``: node-axis max of pixel-replicated quantities.
    - ``psum_pixel``: pixel-axis completion of per-node partial sums.
    - ``gather_pixels``: [..., n_loc] -> [..., n] (pixel-axis all-gather).
    - ``my_pixels``: [..., n] -> [..., n_loc] (this shard's pixel block).
    """

    pair_transpose: Callable | None = None
    psum: Callable = _identity
    any_reduce: Callable = _identity
    psum_repl: Callable = _identity
    pmax_repl: Callable = _identity
    psum_pixel: Callable = _identity
    gather_pixels: Callable = _identity
    my_pixels: Callable = _identity


LOCAL_COMM = CommOps()


class AdmmState(NamedTuple):
    node: NodeState  # x [P_loc, n] + TV duals (warm start)
    Z: torch.Tensor  # [P_loc, P, n_loc] edge consensus variables
    Y: torch.Tensor  # [P_loc, P, n_loc] scaled duals y_{(ij), i}
    k: int  # outer iteration counter
    stop: bool  # convergence flag
    rho_scale: torch.Tensor  # effective rho / cfg.rho (1.0: adapt_rho off)


class NodeBlockData(NamedTuple):
    """Problem data the iteration body consumes."""

    fwd: Callable  # [P_loc, n] -> [P_loc, m]
    adj: Callable  # [P_loc, m] -> [P_loc, n]
    b: torch.Tensor  # [P_loc, m]
    Q: torch.Tensor  # [P_loc, P, n_loc] masked precisions
    adjm: torch.Tensor  # [P_loc, P] union adjacency (float mask)
    W: torch.Tensor  # [P_loc, n] own fusion weights (weighted fusion)
    L: torch.Tensor  # [P_loc] Lipschitz bounds
    x_true: torch.Tensor  # [n]
    N: int
    g_scale: torch.Tensor | None = None  # [P_loc] ||A_i^T b_i|| (eps_rel)
    # Circulant metric of algorithm="fcv", built once per run_admm call.
    fprecond: node_solver.FourierPrecond | None = None
    W_all: torch.Tensor | None = None  # [P, n] every node's weights (mesh)


HISTORY_FIELDS = (
    # name, per-node?
    ("primal", False),
    ("dual", False),
    ("pri_per_node", True),
    ("dual_per_node", True),
    ("obj_per_node", True),
    ("obj_total", False),
    ("mse_sino_per_node", True),
    ("mse_sino_total", False),
    ("img_mse_per_node", True),
    ("img_mse_total", False),
    ("g_norm", True),
    ("eps_target", False),
    ("eps_per_node", True),
    ("inner_iters", True),
    # 0 = accepted at eps_k, 1 = plateau exit, 2 = budget exhausted
    ("accept_code", True),
    ("rho", False),  # effective rho this iteration
)


def make_history(T: int, P: int, device, dtype=torch.float32) -> dict:
    return {
        name: torch.full((T, P) if per_node else (T,), float("nan"),
                         dtype=dtype, device=device)
        for name, per_node in HISTORY_FIELDS
    }


def grow_history(hist: dict, max_iters: int) -> dict:
    """NaN-pad history buffers along the iteration axis to ``max_iters``;
    buffers already at least that long pass through."""
    out = {}
    for name, v in hist.items():
        cur = v.shape[0]
        if cur >= max_iters:
            out[name] = v
        else:
            pad = torch.full((max_iters - cur,) + tuple(v.shape[1:]),
                             float("nan"), dtype=v.dtype, device=v.device)
            out[name] = torch.cat([v, pad], dim=0)
    return out


RHO_MODES = ("balance", "stall")


def check_config(cfg: AdmmConfig) -> None:
    """Raise ValueError for option values the JAX package refuses."""
    if cfg.z_fusion not in consensus.FUSIONS:
        raise ValueError("z_fusion must be 'midpoint' or 'weighted'")
    if cfg.node.algorithm not in node_solver.ALGORITHMS:
        raise ValueError(f"unknown inner algorithm {cfg.node.algorithm!r}")
    if cfg.adapt_rho and cfg.adapt_rho_mode not in RHO_MODES:
        raise ValueError("adapt_rho_mode must be 'balance' or 'stall'")


def _rho_factor(cfg: AdmmConfig, k: int, pri_norm, dual_norm, hist: dict):
    """The factor of this outer's rho change (after row k of ``hist`` is
    written), or None for no change. "balance": rho_tau when the primal
    residual dominates the dual by rho_mu, 1/rho_tau the other way round.
    "stall": every rho_stall_window outers from the second window on,
    rho_tau when the primal residual fell by less than rho_stall_tol since
    row k - window (never lowered)."""
    if cfg.adapt_rho_mode == "stall":
        w = cfg.rho_stall_window
        if (k + 1) % w or k + 1 < 2 * w:
            return None
        prev = hist["primal"][max(k - w, 0)].to(pri_norm.dtype)
        return torch.where(pri_norm > (1.0 - cfg.rho_stall_tol) * prev,
                           cfg.rho_tau, 1.0)
    return torch.where(
        pri_norm > cfg.rho_mu * dual_norm, cfg.rho_tau,
        torch.where(dual_norm > cfg.rho_mu * pri_norm, 1.0 / cfg.rho_tau,
                    1.0))


def _neighbour_terms(Q: torch.Tensor, Z: torch.Tensor, Y: torch.Tensor,
                     comm: CommOps) -> tuple[torch.Tensor, ...]:
    """The consensus terms of the node subproblems, a row per node problem:
    D = sum_j Q_ij, b_cons = sum_j Q_ij v_ij and c = sum_{j,p} Q_ij v_ij^2
    with v_ij = z_ij - y_ij,i. Z and Y may carry a leading batch axis
    (rows b-major; D is every scenario's)."""
    V = Z - Y
    D_vec = comm.gather_pixels(torch.sum(Q, dim=1))
    if V.dim() == 4:
        D_vec = D_vec.repeat(V.shape[0], 1)
    QV = Q * V
    b_cons = comm.gather_pixels(torch.sum(QV, dim=-2).flatten(0, -2))
    c_quad = comm.psum_pixel(torch.sum(QV * V, dim=(-2, -1)).flatten())
    return D_vec, b_cons, c_quad


def _solve_setup(cfg: AdmmConfig, data: NodeBlockData, nstate: NodeState,
                 k: int, rho, D_vec: torch.Tensor):
    """The node solve's start, target and step bounds at outer ``k``:
    (start state, eps_k, L, fcv preconditioner). ``rho`` is a float, a
    0-d tensor under adapt_rho, or per node problem."""
    x = nstate.x
    profiling.count("sync")
    with profiling.span("sync", site="admm.decay"):
        decay = torch.tensor(k + 1.0, dtype=x.dtype, device=x.device)
    decay = decay ** (1.0 + cfg.node.gamma_decay)
    eps_k = cfg.node.eps0 / decay
    if cfg.node.eps_rel > 0:
        eps_k = torch.maximum(eps_k, cfg.node.eps_rel * data.g_scale / decay)
    if not cfg.node.warm_start:
        nstate = node_solver.init_state(
            x.shape[0], data.N, data.b.shape[1], x.device, x.dtype
        )._replace(x=x)
    L, fprecond = data.L, data.fprecond
    if cfg.adapt_rho:
        # Under a drifted rho the Lipschitz bound gains (rho_k - rho0)
        # max_p D, and fcv's certified step scales by min(1, rho0/rho_k)
        # (the rho term is at most the whole of S(rho0) scaled), so it
        # stays certified without a new Lanczos run. The carried tk is
        # reset to the fresh sentinel, so a smaller step after a high-rho
        # outer does not ratchet.
        L = L + (rho - cfg.rho) * torch.amax(D_vec, dim=1)
        if fprecond is not None:
            fprecond = fprecond._replace(step=fprecond.step * torch.clamp(
                cfg.rho / rho, max=1.0).to(fprecond.step.dtype))
            nstate = nstate._replace(tk=torch.full_like(nstate.tk,
                                                        float("inf")))
    return nstate, eps_k, L, fprecond


def _proposal(cfg: AdmmConfig, Xe: torch.Tensor, Z: torch.Tensor,
              Y: torch.Tensor) -> torch.Tensor:
    """a_i = x^_ij + y_ij,i with the over-relaxed x^_ij = alpha x_i +
    (1 - alpha) z_ij, which replaces x_i in the z/y updates and residuals
    (x^ - z = a - y - z); ``Xe`` is x_i with a unit j axis."""
    if cfg.relax_alpha != 1.0:
        return cfg.relax_alpha * Xe + (1.0 - cfg.relax_alpha) * Z + Y
    return Xe + Y


def _consensus_op(cfg: AdmmConfig, dev: torch.device, P: int) -> Callable:
    """K5 or its plain version: ``use_pallas``, or by the auto rule the
    fused kernel on a card at >= 8 nodes."""
    use_pallas = cfg.use_pallas
    if use_pallas is None:
        use_pallas = dev.type == "cuda" and P >= 8
    return (consensus.consensus_update if use_pallas
            else consensus.consensus_update_ref)


def _history_row(res: node_solver.NodeSolveResult, mse_sino: torch.Tensor,
                 img_mse: torch.Tensor, pri_pair: torch.Tensor,
                 dz2_pair: torch.Tensor, eps_k, rho, comm: CommOps):
    """The residuals (eqs. 4-5) and this outer's history row: (primal
    norm, dual norm, {field: value}). The per-node arrays are [P_loc], or
    [B, P] with a batch, and every total is over the last axis; ``rho`` is
    a float, a 0-d tensor, or per scenario [B]."""
    shape = mse_sino.shape
    dtype, dev = mse_sino.dtype, mse_sino.device
    rho_c = rho[..., None] if isinstance(rho, torch.Tensor) else rho
    pri_part = torch.sum(pri_pair, dim=-1)  # pixel-partial
    dz2_part = torch.sum(dz2_pair, dim=-1)
    pri_norm = torch.sqrt(comm.psum(torch.sum(pri_part, dim=-1)))
    dual_norm = torch.sqrt(
        0.5 * rho**2 * comm.psum(torch.sum(dz2_part, dim=-1)))
    eps_node = torch.atleast_1d(eps_k).to(dtype).expand(
        mse_sino.numel()).reshape(shape)
    obj = res.objective.reshape(shape)
    if isinstance(rho, torch.Tensor):
        rho_t = torch.as_tensor(rho, dtype=dtype, device=dev)
    else:  # a host scalar's copy to a card waits for its queue
        profiling.count("sync")
        with profiling.span("sync", site="admm.rho"):
            rho_t = torch.as_tensor(rho, dtype=dtype, device=dev)
    return pri_norm, dual_norm, {
        "primal": pri_norm,
        "dual": dual_norm,
        "pri_per_node": torch.sqrt(comm.psum_pixel(pri_part)),
        "dual_per_node": torch.sqrt(rho_c**2 * comm.psum_pixel(dz2_part)),
        "obj_per_node": obj,
        "obj_total": comm.psum_repl(torch.sum(obj, dim=-1)),
        "mse_sino_per_node": mse_sino,
        "mse_sino_total": comm.psum_repl(torch.sum(mse_sino, dim=-1)),
        "img_mse_per_node": img_mse,
        "img_mse_total": comm.psum_repl(torch.sum(img_mse, dim=-1)),
        "g_norm": res.g_norm.reshape(shape),
        "eps_target": comm.pmax_repl(torch.amax(eps_node, dim=-1)),
        "eps_per_node": eps_node,
        "inner_iters": res.inner_iters.reshape(shape).to(dtype),
        "accept_code": res.accept_code.reshape(shape).to(dtype),
        "rho": rho_t.expand(shape[:-1]),
    }


def _adapt_rho(cfg: AdmmConfig, k: int, pri_norm, dual_norm, hist: dict,
               rho_scale: torch.Tensor, Yn: torch.Tensor):
    """rho adaptation after this outer's residuals (row k of ``hist``
    written): (new rho_scale, Yn), the scaled duals absorbing the inverse
    factor (y = lambda / rho). On a mesh the residuals are all-reduced, so
    every shard takes the same factor."""
    if cfg.adapt_rho:
        factor = _rho_factor(cfg, k, pri_norm, dual_norm, hist)
        if factor is not None:
            new_scale = torch.clamp(rho_scale * factor.to(rho_scale.dtype),
                                    1.0 / cfg.rho_clamp, cfg.rho_clamp)
            Yn = Yn * (rho_scale / new_scale)[..., None, None, None]
            rho_scale = new_scale
    return rho_scale, Yn


def admm_iteration(data: NodeBlockData, cfg: AdmmConfig, state: AdmmState,
                   hist: dict, comm: CommOps = LOCAL_COMM) -> AdmmState:
    """One outer consensus iteration over this shard's node block; writes
    row ``state.k`` of ``hist`` in place and returns the next state. The
    edge state may carry only this shard's pixel block; ``comm`` bridges it
    to the node solves, which see full images."""
    P = data.Q.shape[1]
    k = state.k
    X, Z, Y = state.node.x, state.Z, state.Y
    # The effective rho: the config's, or under adapt_rho its multiple by
    # the carried scale (a 0-d tensor; the off path adds no op).
    rho = cfg.rho * state.rho_scale if cfg.adapt_rho else cfg.rho

    # --- inexact node solve (eq. 1) with the adaptive target ---
    with profiling.span("admm.neighbours"):
        D_vec, b_cons, c_quad = _neighbour_terms(data.Q, Z, Y, comm)
    nstate, eps_k, L, fprecond = _solve_setup(cfg, data, state.node, k, rho,
                                              D_vec)
    res = node_solver.solve_nodes(
        data.fwd, data.adj, data.b, D_vec, b_cons, c_quad,
        cfg.lam_tv, rho, L, nstate, eps_k, cfg.node, data.N,
        fprecond=fprecond, any_reduce=comm.any_reduce,
    )
    Xn = res.state.x

    # --- edge fusion (eq. 2), dual update (eq. 3), residuals (eqs. 4-5) ---
    # a_i laid out [i_loc, j, n_loc] over this shard's pixel block.
    with profiling.span("admm.consensus"):
        A_prop = _proposal(cfg, comm.my_pixels(Xn)[:, None, :], Z, Y)
        update = _consensus_op(cfg, X.device, P)
        if comm.pair_transpose is None:  # every pair is local
            Zn, Yn, pri_pair, dz2_pair = update(A_prop, Y, Z, data.adjm,
                                                data.W, cfg.z_fusion)
        else:
            Zn, Yn, pri_pair, dz2_pair = update(
                A_prop, Y, Z, data.adjm, fusion=cfg.z_fusion,
                a_t=comm.pair_transpose(A_prop),
                w_own=comm.my_pixels(data.W).contiguous(),
                w_all=comm.my_pixels(data.W_all).contiguous())

    # --- metrics in measurement and image space, and the history row ---
    with profiling.span("admm.history"):
        r_meas = data.fwd(Xn) - data.b
        mse_sino = torch.sum(r_meas * r_meas, dim=1)
        err = Xn - data.x_true[None, :]
        img_mse = torch.sum(err * err, dim=1)
        pri_norm, dual_norm, updates = _history_row(
            res, mse_sino, img_mse, pri_pair, dz2_pair, eps_k, rho, comm)
        for name, arr in hist.items():
            arr[k] = updates[name].to(arr.dtype)

    profiling.count("sync")
    with profiling.span("sync", site="admm.stop"):
        stop = bool((pri_norm < cfg.eps_pri) & (dual_norm < cfg.eps_dual))
    rho_scale, Yn = _adapt_rho(cfg, k, pri_norm, dual_norm, hist,
                               state.rho_scale, Yn)
    return AdmmState(node=res.state, Z=Zn, Y=Yn, k=k + 1, stop=stop,
                     rho_scale=rho_scale)


def block_data(problem: Problem, cfg: AdmmConfig,
               lanczos_v0: torch.Tensor | None = None) -> NodeBlockData:
    """The constants of a run that ``admm_iteration`` reads (operators,
    Lipschitz bound, fcv preconditioner), as ``run_admm`` builds them."""
    # Lipschitz bound of the node solves: ||A^T A|| + rho * max_p sum_j Q.
    D_vec = torch.sum(problem.Q, dim=1)
    L = problem.opnorm + cfg.rho * torch.amax(D_vec, dim=-1)
    g_scale = None
    if cfg.node.eps_rel > 0:
        g_scale = torch.linalg.norm(problem.adjoint(problem.b), dim=1)
    fprecond = None
    if cfg.node.algorithm == "fcv":
        with profiling.span("admm.fcv_build"):
            fprecond = node_solver.build_fourier_precond(
                problem.forward, problem.adjoint, D_vec, cfg.rho, cfg.node,
                problem.N, v0=lanczos_v0,
            )
    return NodeBlockData(
        fwd=problem.forward, adj=problem.adjoint, b=problem.b, Q=problem.Q,
        adjm=problem.adj.to(problem.b.dtype), W=problem.W, L=L,
        x_true=problem.x_true, N=problem.N, g_scale=g_scale,
        fprecond=fprecond,
    )


class AdmmResult(NamedTuple):
    x: torch.Tensor  # [P, n] final per-node reconstructions
    history: dict  # rows >= n_iters are NaN
    n_iters: int
    state: AdmmState


def init_state(problem: Problem, cfg: AdmmConfig) -> tuple[AdmmState, dict]:
    """Fresh loop state and history buffers."""
    dtype = problem.b.dtype
    dev = problem.device
    P, n, N = problem.num_nodes, problem.n, problem.N
    profiling.count("sync")
    with profiling.span("sync", site="admm.init"):
        rho_scale = torch.tensor(1.0, dtype=dtype, device=dev)
    state = AdmmState(
        node=node_solver.init_state(P, N, problem.m_flat, dev, dtype),
        Z=torch.zeros((P, P, n), dtype=dtype, device=dev),
        Y=torch.zeros((P, P, n), dtype=dtype, device=dev),
        k=0,
        stop=False,
        rho_scale=rho_scale,
    )
    return state, make_history(cfg.max_iters, P, dev, dtype)


def run_admm(
    problem: Problem,
    cfg: AdmmConfig | None = None,
    state: AdmmState | None = None,
    hist: dict | None = None,
    until: int | None = None,
    lanczos_v0: torch.Tensor | None = None,
) -> AdmmResult:
    """Consensus ADMM on one device, resumable: pass the ``state``/``hist``
    of a previous (possibly partial) run to continue from ``state.k``;
    ``until`` caps this call's last outer iteration (default
    ``cfg.max_iters``). ``hist`` is updated in place.

    ``lanczos_v0`` [n] is the start of fcv's Lanczos step certificate
    (``node_solver.build_fourier_precond``). The JAX package draws it with
    ``jax.random``, which torch cannot reproduce, so a caller that must
    land where the JAX package does passes JAX's draw; by default the port
    draws its own from a seeded generator."""
    cfg = cfg if cfg is not None else problem.cfg.admm
    check_config(cfg)
    if state is not None and hist is None:
        raise ValueError("run_admm: resuming needs the history with the state")
    until = cfg.max_iters if until is None else min(until, cfg.max_iters)
    with profiling.span("admm.run", B=1, P=problem.num_nodes, N=problem.N):
        if state is None:
            state, hist = init_state(problem, cfg)
        data = block_data(problem, cfg, lanczos_v0)
        while state.k < until and not state.stop:
            with profiling.span("admm.outer", k=state.k):
                state = admm_iteration(data, cfg, state, hist)
    return AdmmResult(x=state.node.x, history=hist, n_iters=state.k,
                      state=state)


def state_from_numpy(state, hist: dict, device) -> tuple[AdmmState, dict]:
    """A JAX ``AdmmState`` and history (or anything with the same fields
    that ``np.asarray`` reads) as the port's state on ``device``."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    nd = state.node
    node = NodeState(x=t(nd.x), ux=t(nd.ux), uy=t(nd.uy), ua=t(nd.ua),
                     xp=t(nd.xp), tk=t(nd.tk))
    st = AdmmState(node=node, Z=t(state.Z), Y=t(state.Y),
                   k=int(np.asarray(state.k)), stop=bool(np.asarray(state.stop)),
                   rho_scale=t(state.rho_scale))
    return st, {name: t(v) for name, v in hist.items()}


def run_admm_snapshots(
    problem: Problem,
    cfg: AdmmConfig | None = None,
    snapshot_dir: str | None = None,
    snapshot_every: int | None = None,
    snapshot_div: int = 10,
    mesh=None,
) -> AdmmResult:
    """:func:`run_admm` in segments of ``snapshot_every`` outers (default
    ``max_iters // snapshot_div``, at least 1), writing every node's image
    after each segment to ``snapshot_dir`` as ``iter_<k:04d>_node_<i>``
    ``.npy`` and ``.png``. The segments continue one another exactly
    (the ``state``/``hist``/``until`` contract). With ``mesh`` every rank
    calls it: the segments run through ``run_admm_sharded`` on the rank's
    blocks, rank 0 writes the images of the gathered state, and every rank
    returns the gathered result."""
    from dip_admm_tpu_torch.utils import artifacts

    cfg = cfg if cfg is not None else problem.cfg.admm
    if snapshot_every is None:
        snapshot_every = max(1, cfg.max_iters // snapshot_div)
    if snapshot_every < 1:
        raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
    run, gather, state, hist = segment_driver(problem, cfg, mesh)
    write = snapshot_dir is not None and (mesh is None or mesh.rank == 0)
    while True:
        upto = min(state.k + snapshot_every, cfg.max_iters)
        res = run(state=state, hist=hist, until=upto)
        state, hist = res.state, res.history
        whole = gather(res)
        if write:
            artifacts.save_recons(whole.x, problem.N, snapshot_dir,
                                  f"iter_{state.k:04d}")
        if state.stop or state.k >= cfg.max_iters:
            break
    if write:
        artifacts.flush_async()
    if mesh is not None:
        mesh.barrier()
    return whole


def segment_driver(problem: Problem, cfg: AdmmConfig, mesh=None):
    """(run, gather, state, hist) of a segmented run on one device or on
    ``mesh``: ``run(state=, hist=, until=)`` continues a run (on the rank's
    blocks under a mesh), ``gather(res)`` gives its whole arrays (the
    identity on one device), and a fresh state and history to start from."""
    if mesh is None:
        state, hist = init_state(problem, cfg)
        return (lambda **kw: run_admm(problem, cfg, **kw), _identity,
                state, hist)
    from dip_admm_tpu_torch.parallel import admm_sharded

    state, hist = admm_sharded.init_state(problem, cfg, mesh)
    return (lambda **kw: admm_sharded.run_admm_sharded(problem, cfg, mesh,
                                                       **kw),
            lambda res: admm_sharded.gather_result(res, mesh), state, hist)


def _tile_precond(fp: node_solver.FourierPrecond | None,
                  B: int) -> node_solver.FourierPrecond | None:
    """fcv's preconditioner of the P nodes, repeated for a b-major batch of
    B x P node problems (the operator, D and rho are the scenarios')."""
    if fp is None:
        return None
    return node_solver.FourierPrecond(m_hat=fp.m_hat.repeat(B, 1, 1),
                                      step=fp.step.repeat(B),
                                      sigma=fp.sigma.repeat(B))


def _batched_iteration(data: NodeBlockData, cfg: AdmmConfig,
                       state: AdmmState, hist: dict, running: torch.Tensor,
                       all_running: bool) -> AdmmState:
    """One outer iteration of every scenario of a batch (see
    :func:`run_admm_batched`): ``admm_iteration``'s equations with the
    node axis of the node solves B x P long, b-major, the edge state
    [B, P, P, n] and every total and residual per scenario. Writes row
    ``state.k`` of the scenarios in ``running`` [B] (the time-major
    ``hist`` [T, B, ...]); their new state is returned, the others' as it
    was. ``all_running`` is the host's copy of ``running.all()``."""
    P, _, n = data.Q.shape
    B = running.shape[0]
    k = state.k
    Z, Y = state.Z, state.Y
    # rho per scenario ([B], and per node problem [B * P]) under adapt_rho.
    if cfg.adapt_rho:
        rho_b = cfg.rho * state.rho_scale
        rho = rho_b.repeat_interleave(P)
    else:
        rho_b = rho = cfg.rho

    with profiling.span("admm.neighbours"):
        D_vec, b_cons, c_quad = _neighbour_terms(data.Q, Z, Y, LOCAL_COMM)
    nstate, eps_k, L, fprecond = _solve_setup(cfg, data, state.node, k, rho,
                                              D_vec)
    res = node_solver.solve_nodes(
        data.fwd, data.adj, data.b, D_vec, b_cons, c_quad, cfg.lam_tv, rho,
        L, nstate, eps_k, cfg.node, data.N, fprecond=fprecond, groups=B,
        group_active=None if all_running else running,
    )
    Xn = res.state.x

    with profiling.span("admm.consensus"):
        A_prop = _proposal(cfg, Xn.reshape(B, P, 1, n), Z, Y)
        update = _consensus_op(cfg, Xn.device, P)
        Zn, Yn, pri_pair, dz2_pair = update(A_prop, Y, Z, data.adjm, data.W,
                                            cfg.z_fusion)

    with profiling.span("admm.history"):
        r_meas = data.fwd(Xn) - data.b
        mse_sino = torch.sum(r_meas * r_meas, dim=1).reshape(B, P)
        err = Xn.reshape(B, P, n) - data.x_true[:, None, :]
        img_mse = torch.sum(err * err, dim=2)
        pri_norm, dual_norm, updates = _history_row(
            res, mse_sino, img_mse, pri_pair, dz2_pair, eps_k, rho_b,
            LOCAL_COMM)
        for name, arr in hist.items():
            new = updates[name].to(arr.dtype)
            arr[k] = torch.where(
                running.reshape((B,) + (1,) * (new.dim() - 1)), new, arr[k])

    stop = (pri_norm < cfg.eps_pri) & (dual_norm < cfg.eps_dual)
    rho_scale, Yn = _adapt_rho(cfg, k, pri_norm, dual_norm, hist,
                               state.rho_scale, Yn)
    new = AdmmState(node=res.state, Z=Zn, Y=Yn, k=k + 1,
                    stop=state.stop | (running & stop), rho_scale=rho_scale)
    if all_running:  # nothing to freeze
        return new
    # A stopped scenario keeps its state, as under JAX's vmap.
    def keep(a, b, per_node=False):
        m = running.repeat_interleave(P) if per_node else running
        return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    node = NodeState(*(keep(a, b, True)
                       for a, b in zip(new.node, state.node)))
    return new._replace(node=node, Z=keep(new.Z, Z), Y=keep(new.Y, Y),
                        rho_scale=keep(new.rho_scale, state.rho_scale))


def run_admm_batched(
    problem: Problem,
    b_batch: torch.Tensor,
    x_true_batch: torch.Tensor | None = None,
    cfg: AdmmConfig | None = None,
    lanczos_v0: torch.Tensor | None = None,
) -> AdmmResult:
    """Scenario batching: one operator and graph against a batch of
    sinogram sets, the JAX package's ``run_admm_batched`` (its ``vmap`` of
    the whole run; BASELINE config 4).

    b_batch: [B, P, m]; x_true_batch: [B, n] (default: the problem's
    phantom for every scenario). Each scenario runs as
    :func:`run_admm` would run it alone: it stops on its own residuals,
    and is frozen from then on (its later history rows stay NaN) while the
    others go on; the loop ends when every scenario has stopped or at
    ``max_iters``. The scenarios' node problems run as one grouped node
    solve of B x P nodes (b-major) and their edge states as one [B, P, P,
    n] consensus update (K5 under ``use_pallas``, by the auto rule on a
    card at >= 8 nodes). The fcv preconditioner and the Lipschitz bounds
    are built once: they depend on the operator, D and rho alone.

    Returns an ``AdmmResult`` with a leading batch axis on every array:
    x [B, P, n], each history field [B, T, ...], n_iters [B] and the
    state (node fields [B, P, ...], Z and Y [B, P, P, n], k [B], stop [B],
    rho_scale [B]). ``lanczos_v0`` is :func:`run_admm`'s."""
    cfg = cfg if cfg is not None else problem.cfg.admm
    check_config(cfg)
    dev, dtype = problem.device, problem.b.dtype
    P, n, N = problem.num_nodes, problem.n, problem.N
    b_batch = torch.as_tensor(b_batch, dtype=dtype, device=dev)
    B, m = b_batch.shape[0], b_batch.shape[-1]
    if tuple(b_batch.shape) != (B, P, problem.m_flat):
        raise ValueError(f"b_batch has shape {tuple(b_batch.shape)}, "
                         f"expected [B, {P}, {problem.m_flat}]")
    if x_true_batch is None:
        x_true_batch = problem.x_true.expand(B, n)
    x_true_batch = torch.as_tensor(x_true_batch, dtype=dtype, device=dev)
    b_flat = b_batch.reshape(B * P, m)

    with profiling.span("admm.run", B=B, P=P, N=N):
        base = block_data(problem, cfg, lanczos_v0)
        g_scale = None
        if cfg.node.eps_rel > 0:  # ||A_i^T b_i|| of each scenario's data
            g_scale = torch.linalg.norm(problem.adjoint(b_flat), dim=1)
        data = base._replace(b=b_flat, L=base.L.repeat(B),
                             x_true=x_true_batch, g_scale=g_scale,
                             fprecond=_tile_precond(base.fprecond, B))

        state = AdmmState(
            node=node_solver.init_state(B * P, N, m, dev, dtype),
            Z=torch.zeros((B, P, P, n), dtype=dtype, device=dev),
            Y=torch.zeros((B, P, P, n), dtype=dtype, device=dev),
            k=0,
            stop=torch.zeros((B,), dtype=torch.bool, device=dev),
            rho_scale=torch.ones((B,), dtype=dtype, device=dev),
        )
        hist = {name: torch.full((cfg.max_iters, B, P) if per_node
                                 else (cfg.max_iters, B), float("nan"),
                                 dtype=dtype, device=dev)
                for name, per_node in HISTORY_FIELDS}
        n_iters = torch.zeros((B,), dtype=torch.int32, device=dev)
        running = torch.ones((B,), dtype=torch.bool, device=dev)
        go, all_running = cfg.max_iters > 0, True
        while go:
            with profiling.span("admm.outer", k=state.k):
                state = _batched_iteration(data, cfg, state, hist, running,
                                           all_running)
                n_iters = torch.where(running, state.k, n_iters)
                running = ~state.stop
                profiling.count("sync")
                with profiling.span("sync", site="admm.running"):
                    run_host = running.cpu()  # the one host sync of an outer
            go = state.k < cfg.max_iters and bool(run_host.any())
            all_running = bool(run_host.all())
        node = NodeState(*(v.reshape((B, P) + tuple(v.shape[1:]))
                           for v in state.node))
        state = state._replace(node=node, k=n_iters)
        return AdmmResult(x=node.x, history={k: v.transpose(0, 1)
                                             for k, v in hist.items()},
                          n_iters=n_iters, state=state)
