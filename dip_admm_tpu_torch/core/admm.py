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


def admm_iteration(data: NodeBlockData, cfg: AdmmConfig, state: AdmmState,
                   hist: dict, comm: CommOps = LOCAL_COMM) -> AdmmState:
    """One outer consensus iteration over this shard's node block; writes
    row ``state.k`` of ``hist`` in place and returns the next state. The
    edge state may carry only this shard's pixel block; ``comm`` bridges it
    to the node solves, which see full images."""
    P_loc, P, _ = data.Q.shape
    k = state.k
    X, Z, Y = state.node.x, state.Z, state.Y
    dtype = X.dtype
    # The effective rho: the config's, or under adapt_rho its multiple by
    # the carried scale (a 0-d tensor; the off path adds no op).
    rho = cfg.rho * state.rho_scale if cfg.adapt_rho else cfg.rho

    # --- neighbour terms of the node subproblems ---
    V = Z - Y  # v_ij = z_ij - y_ij,i
    D_vec = comm.gather_pixels(torch.sum(data.Q, dim=1))
    QV = data.Q * V
    b_cons = comm.gather_pixels(torch.sum(QV, dim=1))
    c_quad = comm.psum_pixel(torch.sum(QV * V, dim=(1, 2)))

    # --- inexact node solve with the adaptive target ---
    decay = torch.tensor(k + 1.0, dtype=dtype, device=X.device) ** (
        1.0 + cfg.node.gamma_decay
    )
    eps_k = cfg.node.eps0 / decay
    if cfg.node.eps_rel > 0:
        eps_k = torch.maximum(eps_k, cfg.node.eps_rel * data.g_scale / decay)
    nstate = state.node
    if not cfg.node.warm_start:
        nstate = node_solver.init_state(
            P_loc, data.N, data.b.shape[1], X.device, dtype
        )._replace(x=state.node.x)
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
    res = node_solver.solve_nodes(
        data.fwd, data.adj, data.b, D_vec, b_cons, c_quad,
        cfg.lam_tv, rho, L, nstate, eps_k, cfg.node, data.N,
        fprecond=fprecond, any_reduce=comm.any_reduce,
    )
    Xn = res.state.x

    # --- metrics in measurement and image space ---
    r_meas = data.fwd(Xn) - data.b
    mse_sino = torch.sum(r_meas * r_meas, dim=1)
    err = Xn - data.x_true[None, :]
    img_mse = torch.sum(err * err, dim=1)

    # --- edge fusion (eq. 2), dual update (eq. 3), residuals (eqs. 4-5) ---
    # Over-relaxation: x^_ij = alpha x_i + (1 - alpha) z_ij replaces x_i in
    # the z/y updates and residuals (x^ - z = a - y - z). a_i = x^_ij + y_ij,i
    # laid out [i_loc, j, n_loc].
    Xn_e = comm.my_pixels(Xn)  # this shard's pixel block of the new iterate
    if cfg.relax_alpha != 1.0:
        Xh = cfg.relax_alpha * Xn_e[:, None, :] + (1.0 - cfg.relax_alpha) * Z
        A_prop = Xh + Y
    else:
        A_prop = Xn_e[:, None, :] + Y
    use_pallas = cfg.use_pallas
    if use_pallas is None:  # auto: the fused kernel on a card at >= 8 nodes
        use_pallas = X.device.type == "cuda" and P >= 8
    update = (consensus.consensus_update if use_pallas
              else consensus.consensus_update_ref)
    if comm.pair_transpose is None:  # every pair is local
        Zn, Yn, pri_pair, dz2_pair = update(A_prop, Y, Z, data.adjm, data.W,
                                            cfg.z_fusion)
    else:
        Zn, Yn, pri_pair, dz2_pair = update(
            A_prop, Y, Z, data.adjm, fusion=cfg.z_fusion,
            a_t=comm.pair_transpose(A_prop),
            w_own=comm.my_pixels(data.W).contiguous(),
            w_all=comm.my_pixels(data.W_all).contiguous())
    pri_part = torch.sum(pri_pair, dim=1)  # [P_loc], pixel-partial
    dz2_part = torch.sum(dz2_pair, dim=1)
    r2 = comm.psum(torch.sum(pri_part))
    s2 = 0.5 * rho**2 * comm.psum(torch.sum(dz2_part))
    pri_norm = torch.sqrt(r2)
    dual_norm = torch.sqrt(s2)

    eps_vec = torch.atleast_1d(eps_k).to(dtype)
    updates = {
        "primal": pri_norm,
        "dual": dual_norm,
        "pri_per_node": torch.sqrt(comm.psum_pixel(pri_part)),
        "dual_per_node": torch.sqrt(rho**2 * comm.psum_pixel(dz2_part)),
        "obj_per_node": res.objective,
        "obj_total": comm.psum_repl(torch.sum(res.objective)),
        "mse_sino_per_node": mse_sino,
        "mse_sino_total": comm.psum_repl(torch.sum(mse_sino)),
        "img_mse_per_node": img_mse,
        "img_mse_total": comm.psum_repl(torch.sum(img_mse)),
        "g_norm": res.g_norm,
        "eps_target": comm.pmax_repl(torch.max(eps_vec)),
        "eps_per_node": eps_vec.expand(P_loc),
        "inner_iters": res.inner_iters.to(dtype),
        "accept_code": res.accept_code.to(dtype),
        "rho": torch.as_tensor(rho, dtype=dtype, device=X.device),
    }
    for name, arr in hist.items():
        arr[k] = updates[name].to(arr.dtype)

    stop = bool((pri_norm < cfg.eps_pri) & (dual_norm < cfg.eps_dual))

    # --- rho adaptation, after this outer's residuals: the scaled duals
    # absorb the inverse factor (y = lambda / rho). The residuals are
    # all-reduced, so every shard takes the same factor.
    rho_scale = state.rho_scale
    if cfg.adapt_rho:
        factor = _rho_factor(cfg, k, pri_norm, dual_norm, hist)
        if factor is not None:
            new_scale = torch.clamp(rho_scale * factor.to(rho_scale.dtype),
                                    1.0 / cfg.rho_clamp, cfg.rho_clamp)
            Yn = Yn * (rho_scale / new_scale)
            rho_scale = new_scale
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
    state = AdmmState(
        node=node_solver.init_state(P, N, problem.m_flat, dev, dtype),
        Z=torch.zeros((P, P, n), dtype=dtype, device=dev),
        Y=torch.zeros((P, P, n), dtype=dtype, device=dev),
        k=0,
        stop=False,
        rho_scale=torch.tensor(1.0, dtype=dtype, device=dev),
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
    if state is None:
        state, hist = init_state(problem, cfg)
    if hist is None:
        raise ValueError("run_admm: resuming needs the history with the state")
    until = cfg.max_iters if until is None else min(until, cfg.max_iters)
    data = block_data(problem, cfg, lanczos_v0)
    while state.k < until and not state.stop:
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
    (the ``state``/``hist``/``until`` contract). A mesh is not supported
    yet: a rank holds only its node block."""
    from dip_admm_tpu_torch.utils import artifacts

    if mesh is not None:
        raise ValueError("snapshots (--snapshot-every) are not supported on "
                         "a mesh yet")
    cfg = cfg if cfg is not None else problem.cfg.admm
    if snapshot_every is None:
        snapshot_every = max(1, cfg.max_iters // snapshot_div)
    if snapshot_every < 1:
        raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
    state, hist = init_state(problem, cfg)
    while True:
        upto = min(state.k + snapshot_every, cfg.max_iters)
        res = run_admm(problem, cfg, state=state, hist=hist, until=upto)
        state, hist = res.state, res.history
        if snapshot_dir is not None:
            artifacts.save_recons(res.x, problem.N, snapshot_dir,
                                  f"iter_{state.k:04d}")
        if state.stop or state.k >= cfg.max_iters:
            break
    if snapshot_dir is not None:
        artifacts.flush_async()
    return res
