"""The JAX package's reference values for the port's dense runs, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/jax_dense_anchors.py \
        [flagship] [inner] [rho] [strategies] [batched] [solvers] \
        [matrix_free]

Each run prints one JSON line with its mean PSNR over the nodes (against
the phantom, data range its max), outers run and mean inner iterations:

- ``flagship``: the reference flagship, the package's defaults (64^2, 5
  nodes, const phantom, mode auto = dense, cv at <= 200 inner, 200 outers
  with the 1e-3 stop);
- ``inner``: 64^2/5 dense, 20 outers at max_inner 50 (no early stop) under
  each of cv, pcv, ppdhg and fista;
- ``rho``: 64^2/8 dense, 20 outers of the recommended preset (fcv, 15/15,
  relax 1.8, no early stop) under ``--rho 20 --adapt-rho --rho-mu 2`` and
  ``--rho 2 --adapt-rho --rho-mode stall --rho-stall-window 5``, with each
  run's rho trajectory;
- ``strategies``: the flagship under the mst, chain and complete per-pixel
  graphs (seed 123). It also writes JAX's chain node orders of that run
  (one permutation of the 5 nodes per pixel, 4096 x 5, int8) to
  ``scripts/chain_orders_64x5_seed123.npy``, which ``chip_smoke.py`` hands
  to the port's chain graph so that both packages run the same graph;
- ``batched``: ``run_admm_batched`` on 64^2/5 dense (cv at <= 100 inner,
  20 outers, no early stop) over the phantoms ``rand_im(64, seed=s)``,
  s = 0..3, each sinogram the problem's forward of its phantom plus the
  numpy noise of :func:`batch_noise`; each lane's mean PSNR and their mean;
- ``solvers``: on the flagship problem (64^2/5, dense; const phantom) the
  centralized ridge (Cholesky) and ridge by CG on ``joseph``,
  centralized TV under cv and fcv, pdhg-consensus at the reference
  defaults under both anchor weightings, and the SnapVX-shaped dense
  GraphProblem (nodes A_i, b_i, diag W_i; the knn union edges with Q_ij;
  50 outers); then BASELINE config 1, centralized TV under fcv on a 128^2
  Shepp-Logan, on the ``joseph`` operator (dense's operator without A).
  It also writes JAX's fcv Lanczos start (``jax.random.normal(PRNGKey(0),
  (n,))``) at n = 64^2 and 128^2 to ``scripts/jax_lanczos_v0.npz``, which
  ``chip_smoke.py`` hands to the port's fcv runs of these phases;
- ``matrix_free``: mode ``fft`` (the split-table projector, f32 tables) on
  a 64^2 Shepp-Logan with 4 nodes, parallel and fan beam (192 fan angles),
  20 outers of the recommended preset (fcv 15/15, relax 1.8, no early
  stop; the fcv Lanczos start of ``scripts/jax_lanczos_v0.npz``, which is
  JAX's own draw). The bench size (256^2/8) is left to the card: its
  tables and hat weights take several GiB, more than a shared CPU host
  should give one process.

``chip_smoke.py`` holds the port on the card to these values.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from dip_admm_tpu import config
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader
from dip_admm_tpu.utils.imaging import psnr


def _run(tag, cfg, mode=None, **extra):
    t0 = time.perf_counter()
    problem = loader.build_problem(cfg, mode=mode)
    res = admm.run_admm(problem, cfg.admm)
    n = int(res.n_iters)
    x = np.asarray(res.x)
    x_true = np.asarray(problem.x_true)
    out = {
        "run": tag, "mode": problem.mode, "outers": n,
        "mean_psnr": float(np.mean([psnr(xi, x_true, data_range=x_true.max())
                                    for xi in x])),
        "mean_inner": float(np.asarray(res.history["inner_iters"])[:n].mean()),
        "rho": np.asarray(res.history["rho"])[:n].tolist(),
        "seconds": time.perf_counter() - t0, **extra,
    }
    print(json.dumps(out), flush=True)


CHAIN_ORDERS = "scripts/chain_orders_64x5_seed123.npy"
# Lane s of the batched run draws its noise from default_rng(this + s).
BATCH_NOISE_SEED = 1000


def batch_noise(s: int, shape) -> np.ndarray:
    """The standard-normal noise of lane ``s`` of the batched runs (numpy,
    so that both packages draw the same)."""
    return np.random.default_rng(BATCH_NOISE_SEED + s).standard_normal(
        shape, dtype=np.float32)


def _psnr_nodes(x, x_true) -> float:
    x, x_true = np.asarray(x), np.asarray(x_true)
    return float(np.mean([psnr(xi, x_true, data_range=x_true.max())
                          for xi in x]))


def batched(base) -> None:
    from dip_admm_tpu.ops import phantoms

    t0 = time.perf_counter()
    cfg = dataclasses.replace(base, admm=_admm(
        base.admm, max_iters=20, eps_pri=0.0, eps_dual=0.0,
        node={"max_inner": 100}))
    problem = loader.build_problem(cfg)
    P, N = problem.num_nodes, problem.N
    row_valid = np.repeat(np.asarray(problem.angle_valid), N, axis=1)
    xs, bs = [], []
    for s in range(4):
        x = phantoms.rand_im(N, seed=s).astype(np.float32).reshape(-1)
        clean = np.asarray(problem.forward(jnp.broadcast_to(
            jnp.asarray(x), (P, x.size))))
        bs.append(clean + cfg.noise_level * batch_noise(s, clean.shape)
                  * row_valid)
        xs.append(x)
    res = admm.run_admm_batched(problem, jnp.asarray(np.stack(bs)),
                                jnp.asarray(np.stack(xs)), cfg.admm)
    lanes = [_psnr_nodes(res.x[s], xs[s]) for s in range(4)]
    print(json.dumps({
        "run": "batched_64x5_rand4", "mode": problem.mode,
        "outers": np.asarray(res.n_iters).tolist(), "lane_psnr": lanes,
        "mean_psnr": float(np.mean(lanes)),
        "seconds": time.perf_counter() - t0}), flush=True)


def _solver_line(tag, t0, x, x_true, **extra) -> None:
    x = np.asarray(x).reshape(-1, np.asarray(x_true).size)
    print(json.dumps({"run": tag, "psnr": _psnr_nodes(x, x_true),
                      "seconds": time.perf_counter() - t0, **extra}),
          flush=True)


LANCZOS_V0 = "scripts/jax_lanczos_v0.npz"


def solvers(base) -> None:
    from dip_admm_tpu.solvers import centralized, graph_problem
    from dip_admm_tpu.solvers import pdhg_consensus

    np.savez(LANCZOS_V0, **{f"n{n}": np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (n,), jnp.float32)) for n in (64**2, 128**2)})

    problem = loader.build_problem(base)
    joseph = loader.build_problem(base, mode="joseph")
    xt = problem.x_true
    t0 = time.perf_counter()
    _solver_line("ridge_dense", t0,
                 centralized.ridge_reconstruction(problem, lam=1e-3), xt)
    t0 = time.perf_counter()
    _solver_line("ridge_cg_joseph", t0,
                 centralized.ridge_reconstruction(joseph, lam=1e-3), xt)
    for alg in ("cv", "fcv"):
        t0 = time.perf_counter()
        x, g = centralized.tv_reconstruction(
            problem, lam_tv=base.admm.lam_tv,
            cfg=config.NodeSolverConfig(max_inner=2000, check_every=50,
                                        algorithm=alg))
        _solver_line(f"centralized_tv_{alg}", t0, x, xt,
                     final_stationarity=float(g))
    for weights in ("oracle", "residual"):
        t0 = time.perf_counter()
        res = pdhg_consensus.solve(problem, pdhg_consensus.PdhgConsensusConfig(
            anchor_weights=weights))
        _solver_line(f"pdhg_{weights}", t0, res.x_nodes, xt,
                     agg_psnr=_psnr_nodes(res.x_agg[None], xt))
    t0 = time.perf_counter()
    gp = graph_problem.GraphProblem(problem.N)
    A, b, W = (np.asarray(v) for v in (problem.A, problem.b, problem.W))
    for i in range(problem.num_nodes):
        gp.add_node(A=A[i], b=b[i], diag_quad=W[i])
    adj, Q = np.asarray(problem.adj), np.asarray(problem.Q)
    for i, j in zip(*np.nonzero(np.triu(adj, 1))):
        gp.add_edge(int(i), int(j), Q[i, j])
    x, hist = gp.solve(max_iters=50)
    _solver_line("graph_problem_dense", t0, x, xt,
                 final_primal=float(hist["primal"][-1]))
    cfg128 = dataclasses.replace(
        base, geometry=dataclasses.replace(base.geometry, N=128),
        phantom="shepp")
    t0 = time.perf_counter()
    p128 = loader.build_problem(cfg128, mode="joseph")
    x, g = centralized.tv_reconstruction(
        p128, lam_tv=base.admm.lam_tv,
        cfg=config.NodeSolverConfig(max_inner=2000, check_every=50,
                                    algorithm="fcv"))
    _solver_line("centralized_tv_fcv_128_shepp_joseph", t0, x, p128.x_true,
                 final_stationarity=float(g))


def chain_orders(seed: int, n: int, P: int) -> np.ndarray:
    """The node order of each pixel that JAX's chain graph draws
    (``graph/topology.py``: a permutation under fold_in(PRNGKey(seed),
    pixel)), as an [n, P] array."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(n))
    return np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, P))(keys))


def _admm(base, node=None, **kw):
    node = dataclasses.replace(base.node, **(node or {}))
    return dataclasses.replace(base, node=node, **kw)


def main(which) -> None:
    base = config.ProblemConfig()
    if "flagship" in which:
        _run("dense_flagship", base)
    if "inner" in which:
        for alg in ("cv", "pcv", "ppdhg", "fista"):
            cfg = dataclasses.replace(base, admm=_admm(
                base.admm, max_iters=20, eps_pri=0.0, eps_dual=0.0,
                node={"algorithm": alg, "max_inner": 50}))
            _run(f"inner_{alg}", cfg)
    if "rho" in which:
        geo = dataclasses.replace(base.geometry, num_nodes=8)
        rec = _admm(base.admm, max_iters=20, eps_pri=0.0, eps_dual=0.0,
                    relax_alpha=1.8, adapt_rho=True,
                    node={"algorithm": "fcv", "max_inner": 15,
                          "check_every": 15})
        for tag, over in (("rho20_balance_mu2", dict(rho=20.0, rho_mu=2.0)),
                          ("rho2_stall_w5", dict(
                              adapt_rho_mode="stall", rho_stall_window=5))):
            cfg = dataclasses.replace(base, geometry=geo,
                                      admm=dataclasses.replace(rec, **over))
            _run(tag, cfg)
    if "strategies" in which:
        geo = base.geometry
        np.save(CHAIN_ORDERS, chain_orders(base.graph.seed, geo.n,
                                           geo.num_nodes).astype(np.int8))
        for strategy in ("mst", "chain", "complete"):
            cfg = dataclasses.replace(base, graph=dataclasses.replace(
                base.graph, strategy=strategy))
            _run(f"strategy_{strategy}", cfg)
    if "batched" in which:
        batched(base)
    if "solvers" in which:
        solvers(base)
    if "matrix_free" in which:
        rec = _admm(base.admm, max_iters=20, eps_pri=0.0, eps_dual=0.0,
                    relax_alpha=1.8, node={"algorithm": "fcv",
                                           "max_inner": 15,
                                           "check_every": 15})
        for fan in (False, True):
            cfg = dataclasses.replace(
                base, geometry=dataclasses.replace(
                    base.geometry, num_nodes=4, fan_beam=fan),
                admm=rec, phantom="shepp")
            _run("matrix_free_fan" if fan else "matrix_free", cfg,
                 mode="fft")


if __name__ == "__main__":
    main(sys.argv[1:] or ("flagship", "inner", "rho", "strategies",
                          "batched", "solvers", "matrix_free"))
