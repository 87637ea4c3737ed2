"""Run artifacts: the parameter dump, per-node images, history arrays and
curves, the union-graph picture, MSE curves and the edge map.

The file names and contents are the JAX package's (``utils/artifacts.py``),
so a run of either package leaves the same set under its ``out_dir``:

- ``run_parameters.txt``: the config as JSON, the date and the extra
  fields (the union graph's summary);
- ``<tag>_node_<i>.npy``/``.png``: each node's image (the PNGs through the
  native writer, or matplotlib);
- ``<tag>_<curve>.npy`` and ``.png``: the history's curves (stationarity,
  objectives, residuals, sinogram and image MSE, inner iterations,
  acceptance codes, rho);
- ``union_figs/pixel_union_graph_<tag>.png`` and
  ``pixel_union_degree_<tag>.png``.

Everything here is host-side numpy. matplotlib is imported only to draw a
plot: where it is not installed, every ``.npy``, ``run_parameters.txt`` and
the node PNGs of the native writer are still written, and each plot that
could not be drawn is recorded (:func:`take_skipped`) instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime

import numpy as np
import torch

from dip_admm_tpu_torch.ops import tv
from dip_admm_tpu_torch.utils import native_artifacts as na

_skipped: list[str] = []


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None if not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def take_skipped() -> list[str]:
    """The plots not drawn since the last call (no matplotlib), by path;
    clears the record."""
    out = list(_skipped)
    _skipped.clear()
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _trim(history: dict, n_iters: int) -> dict:
    return {k: _np(v)[:n_iters] for k, v in history.items()}


def _savefig(plt, path: str) -> None:
    plt.tight_layout()
    plt.savefig(path, dpi=160)
    plt.close()


def save_run_parameters(out_dir: str, cfg, extra: dict | None = None) -> str:
    """``run_parameters.txt``: the config as JSON, the date, then one
    ``key: value`` line for each of ``extra``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "run_parameters.txt")
    with open(path, "w") as f:
        f.write("===== Global Parameters =====\n")
        f.write(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        f.write(f"\nDate-Time: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k}: {v}\n")
    return path


def save_recons(x, N: int, out_dir: str, tag: str) -> None:
    """Each node's image x[i] as ``<tag>_node_<i>.npy`` and ``.png``: on the
    native writer's threads where it builds (call :func:`flush_async`
    before reading them), else numpy and matplotlib."""
    os.makedirs(out_dir, exist_ok=True)
    x = _np(x)
    native = na.available()
    plt = None if native else _pyplot()
    for i, xi in enumerate(x):
        img = xi.reshape(N, N)
        npy = os.path.join(out_dir, f"{tag}_node_{i}.npy")
        png = os.path.join(out_dir, f"{tag}_node_{i}.png")
        if native:
            na.save_npy(npy, img)
            na.save_png_gray(png, img)
            continue
        np.save(npy, img)
        if plt is None:
            _skipped.append(png)
            continue
        plt.figure(figsize=(5, 5))
        plt.imshow(img, cmap="gray")
        plt.title(f"{tag}  node {i}")
        plt.axis("off")
        _savefig(plt, png)


def flush_async() -> None:
    """Wait for the native writer's queued files (none without it)."""
    if na.available():
        na.flush()


def _semilogy_per_node(arr, title, ylabel, path, floor=1e-12):
    plt = _pyplot()
    if plt is None:
        _skipped.append(path)
        return
    plt.figure(figsize=(6, 4))
    for i in range(arr.shape[1]):
        plt.semilogy(np.abs(arr[:, i]) + floor, label=f"node {i}")
    plt.xlabel("iteration")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend(ncol=2, fontsize=8)
    _savefig(plt, path)


def _semilogy_total(arr, title, ylabel, path, floor=1e-12):
    plt = _pyplot()
    if plt is None:
        _skipped.append(path)
        return
    plt.figure(figsize=(6, 4))
    plt.semilogy(np.abs(np.asarray(arr)) + floor)
    plt.xlabel("iteration")
    plt.ylabel(ylabel)
    plt.title(title)
    _savefig(plt, path)


def save_mse_curves(curves: dict, out_dir: str) -> None:
    """Named trajectories as ``<name>.npy`` and a semilogy ``<name>.png``:
    [T, P] arrays one curve a node, 1-D arrays one curve."""
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in curves.items():
        arr = _np(arr)
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        path = os.path.join(out_dir, f"{name}.png")
        if arr.ndim == 2:
            _semilogy_per_node(arr, name, name, path)
        else:
            _semilogy_total(arr, name, name, path)


def _stationarity_plots(g, eps_target, out_dir, tag, written):
    plt = _pyplot()
    per_node = os.path.join(out_dir, f"{tag}_g_norm_per_node.png")
    stats = os.path.join(out_dir, f"{tag}_g_norm_stats.png")
    if plt is None:
        _skipped.extend((per_node, stats))
        return
    plt.figure(figsize=(7, 4))
    ax1 = plt.gca()
    for i in range(g.shape[1]):
        ax1.semilogy(g[:, i], label=f"node {i}")
    ax1.semilogy(eps_target, "k--", alpha=0.7, label=r"$\varepsilon_k$")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel(r"$\|g_{x,i}\|_2$")
    ax1.set_title(f"Per node stationarity residual, {tag}")
    ax1.grid(True, which="both")
    ax1.legend(ncol=2, fontsize=8)
    _savefig(plt, per_node)
    written.append(per_node)

    plt.figure(figsize=(6, 4))
    plt.semilogy(g.mean(axis=1), label="mean")
    plt.semilogy(np.median(g, axis=1), label="median")
    plt.xlabel("iteration")
    plt.ylabel(r"$\|g_{x,i}\|_2$")
    plt.title(f"Mean and median stationarity residual, {tag}")
    plt.legend()
    _savefig(plt, stats)
    written.append(stats)


def _residual_plot(h, out_dir, tag, written):
    path = os.path.join(out_dir, f"{tag}_residuals.png")
    plt = _pyplot()
    if plt is None:
        _skipped.append(path)
        return
    plt.figure(figsize=(6, 4))
    plt.semilogy(h["primal"], label="primal")
    plt.semilogy(h["dual"], label="dual")
    plt.xlabel("iteration")
    plt.ylabel("L2 norm")
    plt.title(f"Residuals, {tag}")
    plt.legend()
    _savefig(plt, path)
    written.append(path)


def _rho_plot(rho, out_dir, tag, written):
    path = os.path.join(out_dir, f"{tag}_rho_hist.png")
    plt = _pyplot()
    if plt is None:
        _skipped.append(path)
        return
    plt.figure(figsize=(6, 4))
    plt.semilogy(rho)
    plt.xlabel("iteration")
    plt.ylabel(r"effective $\rho$")
    plt.title(f"Adaptive rho trajectory, {tag}")
    plt.grid(True, which="both")
    _savefig(plt, path)
    written.append(path)


def save_history_artifacts(history: dict, n_iters: int, out_dir: str,
                           tag: str, m_per_node=None,
                           N: int | None = None) -> list[str]:
    """The history's arrays and curves, the first ``n_iters`` rows: the
    sinogram MSE divided by m_i (``m_per_node``), the image MSE by N^2;
    residuals, objectives and stationarity per node and in total. Returns
    the paths written (the per-node and total curve plots aside)."""
    os.makedirs(out_dir, exist_ok=True)
    h = _trim(history, n_iters)
    written: list[str] = []

    def saveit(name, arr):
        p = os.path.join(out_dir, f"{tag}_{name}.npy")
        np.save(p, arr)
        written.append(p)
        return arr

    def png(name):
        return os.path.join(out_dir, f"{tag}_{name}.png")

    g = saveit("g_norm_per_node", h["g_norm"])
    _stationarity_plots(g, h["eps_target"], out_dir, tag, written)

    obj_pn = saveit("obj_per_node", h["obj_per_node"])
    _semilogy_per_node(obj_pn, f"Objective per node, {tag}", "objective",
                       png("obj_per_node"))
    obj_t = saveit("obj_total", h["obj_total"])
    _semilogy_total(obj_t, f"Total objective, {tag}", "objective",
                    png("obj_total"))

    pri_pn = saveit("pri_per_node", h["pri_per_node"])
    _semilogy_per_node(pri_pn, f"Primal residual per node, {tag}",
                       "primal residual", png("pri_per_node"))
    dual_pn = saveit("dual_per_node", h["dual_per_node"])
    _semilogy_per_node(dual_pn, f"Dual residual per node, {tag}",
                       "dual residual", png("dual_per_node"))

    saveit("primal_hist", h["primal"])
    saveit("dual_hist", h["dual"])
    _residual_plot(h, out_dir, tag, written)

    if m_per_node is not None:
        m_vec = _np(m_per_node).astype(float)
        mse_pn = saveit("sino_mse_per_node", h["mse_sino_per_node"] / m_vec)
        _semilogy_per_node(mse_pn, f"Per node sinogram MSE, {tag}",
                           "sinogram MSE (1/m_i)||A_i x_i - b_i||^2",
                           png("sino_mse_per_node"))
        mse_t = saveit("sino_mse_total",
                       h["mse_sino_total"] / float(m_vec.sum()))
        _semilogy_total(mse_t, f"Total sinogram MSE, {tag}",
                        "total sinogram MSE", png("sino_mse_total"))

    if N is not None:
        n_pix = float(N * N)
        img_pn = saveit("img_mse_per_node", h["img_mse_per_node"] / n_pix)
        _semilogy_per_node(img_pn, f"Per node image MSE, {tag}",
                           "image MSE (1/N^2)||x_i - x_true||^2",
                           png("img_mse_per_node"))
        img_t = saveit("img_mse_total", h["img_mse_total"] / n_pix)
        _semilogy_total(img_t, f"Total image MSE, {tag}", "total image MSE",
                        png("img_mse_total"))

    if "inner_iters" in h:
        saveit("inner_iters_per_node", h["inner_iters"])
    if "accept_code" in h:
        saveit("accept_code_per_node", h["accept_code"])
    if "rho" in h:
        rho = saveit("rho_hist", h["rho"])
        finite = rho[np.isfinite(rho)]
        if finite.size and (finite.max() - finite.min()) > 1e-12:
            _rho_plot(rho, out_dir, tag, written)
    return written


def save_union_graph(adj, out_dir: str, tag: str) -> str:
    """``pixel_union_graph_<tag>.png`` (the nodes on a circle, an edge a
    straight line) and ``pixel_union_degree_<tag>.png`` (the degree
    histogram). Returns the graph picture's path."""
    os.makedirs(out_dir, exist_ok=True)
    p = os.path.join(out_dir, f"pixel_union_graph_{tag}.png")
    ph = os.path.join(out_dir, f"pixel_union_degree_{tag}.png")
    plt = _pyplot()
    if plt is None:
        _skipped.extend((p, ph))
        return p
    adj = _np(adj)
    P = adj.shape[0]
    theta = 2 * np.pi * np.arange(P) / P
    xs, ys = np.cos(theta), np.sin(theta)
    plt.figure(figsize=(6, 6))
    for i in range(P):
        for j in range(i + 1, P):
            if adj[i, j]:
                plt.plot([xs[i], xs[j]], [ys[i], ys[j]], "b-", alpha=0.6)
    plt.scatter(xs, ys, s=600, c="#ffcc66", zorder=3, edgecolors="k")
    for i in range(P):
        plt.text(xs[i], ys[i], str(i), ha="center", va="center", zorder=4)
    plt.axis("off")
    plt.title(f"pixel union graph, {tag}")
    _savefig(plt, p)

    degrees = adj.sum(axis=1)
    plt.figure(figsize=(6, 4))
    plt.hist(degrees, bins=range(int(degrees.min()), int(degrees.max()) + 2))
    plt.xlabel("Degree")
    plt.ylabel("Count")
    plt.title(f"Node degree histogram, {tag}")
    _savefig(plt, ph)
    return p


def save_edge_map(x, N: int, path: str) -> None:
    """The edge-magnitude image |Kx| of x (``tv.edge_map``) as a PNG."""
    plt = _pyplot()
    if plt is None:
        _skipped.append(path)
        return
    mag = _np(tv.edge_map(torch.as_tensor(_np(x)).reshape(N, N)))
    plt.figure(figsize=(5, 5))
    plt.imshow(mag, cmap="gray")
    plt.axis("off")
    plt.title("edge map")
    _savefig(plt, path)
