"""The JAX package's reference values for the port's dense runs, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/jax_dense_anchors.py \
        [flagship] [inner] [rho] [strategies]

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
  to the port's chain graph so that both packages run the same graph.

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


def _run(tag, cfg, **extra):
    t0 = time.perf_counter()
    problem = loader.build_problem(cfg)
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


if __name__ == "__main__":
    main(sys.argv[1:] or ("flagship", "inner", "rho", "strategies"))
