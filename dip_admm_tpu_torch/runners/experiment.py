"""The strategy experiment: one graph strategy's run with its artifacts,
and mst, chain and knn back to back on the same data.

``run_one_strategy`` builds (or takes, rebuilding only its graph) the
problem, runs consensus ADMM on one device or on a mesh, and writes the
JAX package's artifact set under ``<out_root>/<tag>``; with
``snapshot_every`` it writes every node's image every K outers, with
``checkpoint_every`` it runs in K-outer segments and queues the loop state
to ``<out_dir>/checkpoint.npz`` after each, and ``resume`` continues from
such a checkpoint (of either package). ``run_all_strategies`` and
``evaluate_strategies`` run mst, chain and knn on one problem.
``run_pdhg_consensus`` and ``run_centralized`` run the alternative solvers
(penalized-consensus PDHG, centralized ridge and TV) with the JAX
package's summary keys and artifact names.

On a mesh every rank calls these functions with the same arguments and
builds the problem on its device; the result is gathered on every rank,
and rank 0 alone writes the artifacts, the snapshots and the checkpoints
(of the state gathered after each segment, in the single-device format);
on ``resume`` every rank loads the checkpoint and takes its blocks
(``admm_sharded.take_blocks``), as the JAX package's sharded driver runs
the same segments.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from dip_admm_tpu_torch.config import ProblemConfig
from dip_admm_tpu_torch.core import admm
from dip_admm_tpu_torch.data import loader, serialization
from dip_admm_tpu_torch.graph import topology
from dip_admm_tpu_torch.utils import artifacts
from dip_admm_tpu_torch.utils.imaging import psnr

# The strategies of the experiment, in the reference's order.
STRATEGIES = ("mst", "chain", "knn")


def strategy_tag(graph_cfg) -> str:
    """The run's directory name: ``knn_k<k>`` for knn, else the strategy."""
    if graph_cfg.strategy == "knn":
        return f"knn_k{graph_cfg.k}"
    return graph_cfg.strategy


def check_segments(snapshot_every, checkpoint_every, resume) -> None:
    """Raise ValueError for a combination of the segmented drivers' options
    that :func:`run_one_strategy` does not run."""
    if checkpoint_every is not None and snapshot_every is not None:
        raise ValueError("--checkpoint-every and --snapshot-every are "
                         "separate segmented drivers; pass one or the other")
    for name, every in (("checkpoint", checkpoint_every),
                        ("snapshot", snapshot_every)):
        if every is not None and every < 1:
            raise ValueError(f"--{name}-every must be >= 1, got {every}")
    if resume is not None and checkpoint_every is None:
        raise ValueError("--resume needs --checkpoint-every (the segmented "
                         "driver that continues a checkpoint)")


def _solve(problem, cfg, mesh, out_dir, snapshot_every, checkpoint_every,
           resume):
    """The loop of :func:`run_one_strategy`: snapshots, checkpointed
    segments or one run, on one device or on ``mesh``; a mesh run's
    result gathered onto every rank."""
    if snapshot_every is not None:
        return admm.run_admm_snapshots(
            problem, cfg.admm, snapshot_dir=os.path.join(out_dir, "snapshots"),
            snapshot_every=snapshot_every, mesh=mesh)
    run, gather, state, hist = admm.segment_driver(problem, cfg.admm, mesh)
    if checkpoint_every is None:
        return gather(run(state=state, hist=hist))
    if resume is not None:
        state, hist = serialization.load_checkpoint(resume, problem.device)
        # a checkpoint of a shorter run: its history grows to max_iters
        hist = admm.grow_history(hist, cfg.admm.max_iters)
        if mesh is not None:
            from dip_admm_tpu_torch.parallel import admm_sharded

            state, hist = admm_sharded.take_blocks(state, hist, problem, mesh)
    write = mesh is None or mesh.rank == 0
    ckpt = os.path.join(out_dir, "checkpoint.npz")
    while True:
        res = run(state=state, hist=hist,
                  until=min(state.k + checkpoint_every, cfg.admm.max_iters))
        state, hist = res.state, res.history
        whole = gather(res)
        if write:
            serialization.save_checkpoint_async(ckpt, whole.state,
                                                whole.history)
        if state.stop or state.k >= cfg.admm.max_iters:
            break
    if write:
        serialization.flush_checkpoints()
    if mesh is not None:
        mesh.barrier()
    return whole


def run_one_strategy(
    cfg: ProblemConfig,
    out_root: str,
    strategy: Optional[str] = None,
    k: Optional[int] = None,
    mesh=None,
    problem: Optional[loader.Problem] = None,
    write_artifacts: bool = True,
    mode: Optional[str] = None,
    per_node_phantoms: bool = False,
    snapshot_every: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    resume: Optional[str] = None,
    device: torch.device | str = "cuda",
    orders: Optional[torch.Tensor] = None,
):
    """Run consensus ADMM under one graph strategy (``strategy``/``k``
    replace ``cfg.graph``'s); returns (x [P, n], history, summary), the
    first two as numpy. ``problem`` (built or loaded) is reused with only
    its graph rebuilt where it differs; else one is built on ``device``.
    ``orders`` are the chain graph's node orders
    (``topology.build_pixel_masks``). See the module docstring for the
    snapshots, checkpoints and ``resume``."""
    if strategy is not None or k is not None:
        g = dataclasses.replace(
            cfg.graph,
            strategy=strategy if strategy is not None else cfg.graph.strategy,
            k=k if k is not None else cfg.graph.k)
        cfg = dataclasses.replace(cfg, graph=g)
    check_segments(snapshot_every, checkpoint_every, resume)
    tag = strategy_tag(cfg.graph)
    out_dir = os.path.join(out_root, tag)

    if problem is None:
        problem = loader.build_problem(cfg, device, mode=mode,
                                       per_node_phantoms=per_node_phantoms,
                                       orders=orders)
    elif problem.cfg.graph != cfg.graph:
        problem = loader.rebuild_graph(problem, cfg.graph, orders=orders)

    res = _solve(problem, cfg, mesh, out_dir, snapshot_every,
                 checkpoint_every, resume)
    n_iters = res.n_iters
    # numpy has no bfloat16: a half-precision run's arrays as float32.
    x = res.x.float().cpu().numpy()
    hist = {name: v.float().cpu().numpy() for name, v in res.history.items()}
    N = problem.N
    x_true = problem.x_true.float().cpu().numpy()
    m_per_node = (problem.angle_valid.sum(dim=1)
                  * cfg.geometry.n_det).cpu().numpy()
    summary = {
        "tag": tag,
        "n_iters": n_iters,
        "final_primal": float(hist["primal"][n_iters - 1]),
        "final_dual": float(hist["dual"][n_iters - 1]),
        "mean_psnr": float(np.mean(
            [psnr(xi, x_true, data_range=x_true.max()) for xi in x])),
        "graph": topology.union_summary(problem.keep),
        "out_dir": out_dir,
    }
    if write_artifacts and (mesh is None or mesh.rank == 0):
        artifacts.save_run_parameters(out_dir, cfg, extra=summary["graph"])
        artifacts.save_union_graph(problem.adj,
                                   os.path.join(out_dir, "union_figs"), tag)
        artifacts.save_recons(x, N, out_dir, tag)
        artifacts.save_history_artifacts(hist, n_iters, out_dir, tag,
                                         m_per_node=m_per_node, N=N)
        artifacts.flush_async()
    _note_skipped(summary, out_dir, tag)
    return x, hist, summary


def run_all_strategies(
    cfg: ProblemConfig, out_root: Optional[str] = None, mesh=None,
    mode: Optional[str] = None, per_node_phantoms: bool = False,
    problem: Optional[loader.Problem] = None,
    device: torch.device | str = "cuda",
) -> dict:
    """mst, chain and knn back to back on the same data: one problem
    (``problem``, or one built on ``device``), only the graph layer rebuilt
    for each strategy. Returns each strategy's summary."""
    if out_root is None:
        out_root = f"Recon_Out_ADMM_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    if problem is None:
        problem = loader.build_problem(cfg, device, mode=mode,
                                       per_node_phantoms=per_node_phantoms)
    results = {}
    for strategy in STRATEGIES:
        _, _, results[strategy] = run_one_strategy(
            cfg, out_root, strategy=strategy, mesh=mesh, problem=problem)
    return results


def _mean_psnr(x: np.ndarray, x_true: np.ndarray) -> float:
    return float(np.mean([psnr(xi, x_true, data_range=float(x_true.max()))
                          for xi in np.atleast_2d(x)]))


def run_pdhg_consensus(
    cfg: ProblemConfig,
    out_root: Optional[str] = None,
    n_outer: int = 100,
    lam: float = 0.005,
    gamma: float = 2.0,
    anchor_weights: str = "oracle",
    mode: Optional[str] = None,
    write_artifacts: bool = True,
    device: torch.device | str = "cuda",
    problem: Optional[loader.Problem] = None,
) -> dict:
    """The penalized-consensus PDHG solver as an experiment: builds the
    problem on ``device`` (or takes ``problem``), runs
    ``solvers.pdhg_consensus`` and returns the JAX package's summary
    (per-node and aggregate PSNR and final image MSE); with ``out_root`` it
    writes ``<out_root>/pdhg_consensus/`` (the node and aggregate images
    and the four MSE curves)."""
    from dip_admm_tpu_torch.solvers import pdhg_consensus

    if problem is None:
        problem = loader.build_problem(cfg, device, mode=mode)
    pcfg = pdhg_consensus.PdhgConsensusConfig(
        n_outer=n_outer, lam_tv=lam, lam_agg=lam, gamma=gamma,
        anchor_weights=anchor_weights)
    res = pdhg_consensus.solve(problem, pcfg)
    x = res.x_nodes.cpu().numpy()
    x_agg = res.x_agg.cpu().numpy()
    x_true = problem.x_true.cpu().numpy()
    curves = {k: getattr(res, k).cpu().numpy() for k in (
        "img_mse_nodes", "sino_mse_nodes", "img_mse_agg", "sino_mse_agg")}
    summary = {
        "solver": "pdhg-consensus",
        "n_outer": n_outer,
        "mean_node_psnr": _mean_psnr(x, x_true),
        "agg_psnr": _mean_psnr(x_agg, x_true),
        "final_img_mse_nodes": curves["img_mse_nodes"][-1].tolist(),
        "final_img_mse_agg": float(curves["img_mse_agg"][-1]),
    }
    if write_artifacts and out_root is not None:
        out_dir = os.path.join(out_root, "pdhg_consensus")
        artifacts.save_recons(x, problem.N, out_dir, "pdhg_nodes")
        artifacts.save_recons(x_agg[None, :], problem.N, out_dir,
                              "pdhg_aggregate")
        artifacts.save_mse_curves(curves, out_dir)
        artifacts.flush_async()
        summary["out_dir"] = out_dir
        _note_skipped(summary, out_dir, "pdhg_consensus")
    return summary


def run_centralized(
    cfg: ProblemConfig,
    out_root: Optional[str] = None,
    tv: bool = False,
    ridge_lam: float = 1e-3,
    mode: Optional[str] = None,
    write_artifacts: bool = True,
    device: torch.device | str = "cuda",
    problem: Optional[loader.Problem] = None,
) -> dict:
    """A centralized aggregate baseline as an experiment: ridge least
    squares (``tv=False``) or TV least squares at ``cfg.admm.lam_tv``, on
    a problem built on ``device`` (or ``problem``); the JAX package's
    summary, and with ``out_root`` the image under
    ``<out_root>/centralized_ridge/`` or ``centralized_tv/``."""
    from dip_admm_tpu_torch.solvers import centralized

    if problem is None:
        problem = loader.build_problem(cfg, device, mode=mode)
    if tv:
        x, g_norm = centralized.tv_reconstruction(problem,
                                                  lam_tv=cfg.admm.lam_tv)
        extra = {"final_stationarity": float(g_norm)}
        tag = "centralized_tv"
    else:
        x = centralized.ridge_reconstruction(problem, lam=ridge_lam)
        extra = {"ridge_lam": ridge_lam}
        tag = "centralized_ridge"
    x = x.cpu().numpy()
    x_true = problem.x_true.cpu().numpy()
    summary = {
        "solver": tag,
        "psnr": _mean_psnr(x, x_true),
        "img_mse": float(np.mean((x - x_true) ** 2)),
        **extra,
    }
    if write_artifacts and out_root is not None:
        out_dir = os.path.join(out_root, tag)
        artifacts.save_recons(x[None, :], problem.N, out_dir, tag)
        artifacts.flush_async()
        summary["out_dir"] = out_dir
        _note_skipped(summary, out_dir, tag)
    return summary


def _note_skipped(summary: dict, out_dir: str, tag: str) -> None:
    """Name the plots that were not drawn (no matplotlib) in the summary
    and on stderr."""
    skipped = artifacts.take_skipped()
    if skipped:
        names = [os.path.relpath(p, out_dir) for p in skipped]
        summary["artifacts_skipped"] = names
        print(f"artifacts: matplotlib is not installed; {len(names)} plots "
              f"of {tag} not drawn: {' '.join(names)}", file=sys.stderr)


def evaluate_strategies(cfg: ProblemConfig, mesh=None,
                        device: torch.device | str = "cuda") -> dict:
    """Final residuals and mean PSNR of mst, chain and knn on one problem,
    no artifacts written."""
    out = {}
    problem = loader.build_problem(cfg, device)
    for strategy in STRATEGIES:
        _, _, summary = run_one_strategy(
            cfg, out_root="", strategy=strategy, mesh=mesh, problem=problem,
            write_artifacts=False)
        out[strategy] = {k: summary[k] for k in
                         ("final_primal", "final_dual", "mean_psnr")}
    return out
