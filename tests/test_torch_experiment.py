"""The strategy experiment (``runners/experiment.py``), its snapshots and
the CLI's experiment flags, against the JAX package on the CPU.

``run_one_strategy`` on one JAX bundle (32^2, 4 nodes, dense, 3 outers of
cv) under each of knn, mst, chain (JAX's node orders handed to the port)
and complete, in both packages: the final images within 1e-4 of their max
(the state tolerance of ``test_torch_radon.py``), the residuals and the
mean PSNR within rtol 2e-3 (the histories' tolerance of
``test_torch_cli.py``'s mesh check), the graph summary equal, and the same
set of artifact file names under the run's directory. ``run_all_strategies``
returns mst, chain and knn; ``evaluate_strategies`` gives JAX's keys;
``run_admm_snapshots`` writes JAX's ``iter_*`` names. The CLI's experiment
flags are in ``test_torch_cli_experiment.py``.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.runners import experiment as jexp
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.runners import experiment as texp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
try:
    import chip_smoke
finally:
    sys.path.remove(str(ROOT))

X_RTOL, SUMMARY_RTOL = 1e-4, 2e-3


def _cfg(pkg, N=32, nodes=4, max_iters=3, max_inner=50):
    return pkg.ProblemConfig(
        geometry=pkg.GeometryConfig(N=N, num_nodes=nodes),
        graph=pkg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=pkg.AdmmConfig(max_iters=max_iters, eps_pri=0.0, eps_dual=0.0,
                            node=pkg.NodeSolverConfig(max_inner=max_inner)),
        phantom="shepp")


def jax_chain_orders(seed: int, n: int, P: int) -> torch.Tensor:
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(n))
    return torch.as_tensor(np.array(jax.vmap(
        lambda kk: jax.random.permutation(kk, P))(keys)))


def _files(d) -> set:
    return {str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """One JAX dense problem (32^2, 4 nodes) and the port's load of its
    bundle."""
    cfg_j = _cfg(jcfg)
    pj = jloader.build_problem(cfg_j, mode="dense")
    path = str(tmp_path_factory.mktemp("bundle") / "p.npz")
    jser.save_problem(pj, path)
    return cfg_j, pj, tser.load_problem(path, "cpu")


@pytest.mark.parametrize("strategy", ["knn", "mst", "chain", "complete"])
def test_run_one_strategy_matches_jax(bundle, strategy, tmp_path):
    cfg_j, pj, pt = bundle
    xj, hj, sj = jexp.run_one_strategy(cfg_j, str(tmp_path / "jax"),
                                       strategy=strategy, problem=pj)
    orders = jax_chain_orders(123, pt.n, pt.num_nodes)
    xt, ht, st = texp.run_one_strategy(pt.cfg, str(tmp_path / "port"),
                                       strategy=strategy, problem=pt,
                                       device="cpu", orders=orders)
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=X_RTOL * np.abs(xj).max())
    assert set(st) == set(sj)
    assert st["tag"] == sj["tag"] and st["n_iters"] == sj["n_iters"] == 3
    assert st["graph"] == sj["graph"]
    for k in ("final_primal", "final_dual", "mean_psnr"):
        np.testing.assert_allclose(st[k], sj[k], rtol=SUMMARY_RTOL, err_msg=k)
    assert set(ht) == set(hj)
    assert _files(st["out_dir"]) == _files(sj["out_dir"])
    # The card smoke holds the CLI's directories to this set.
    assert _files(sj["out_dir"]) == chip_smoke.artifact_names(sj["tag"], 4)


def test_run_all_strategies_returns_mst_chain_knn(tmp_path):
    res = texp.run_all_strategies(_cfg(tcfg, N=16, nodes=3, max_iters=1),
                                  str(tmp_path), device="cpu")
    assert list(res) == ["mst", "chain", "knn"]
    assert [s["tag"] for s in res.values()] == ["mst", "chain", "knn_k2"]
    for s in res.values():
        assert os.path.isdir(s["out_dir"])


def test_evaluate_strategies_gives_jax_keys():
    got = texp.evaluate_strategies(_cfg(tcfg, N=16, nodes=3, max_iters=1),
                                   device="cpu")
    want = jexp.evaluate_strategies(_cfg(jcfg, N=16, nodes=3, max_iters=1))
    assert list(got) == list(want)
    for s in got:
        assert list(got[s]) == list(want[s])
        assert all(np.isfinite(v) for v in got[s].values())


def test_snapshots_write_jax_names(tmp_path):
    """run_admm_snapshots at 5 outers every 2: iter_0002, iter_0004 and
    iter_0005 in both packages, and the last snapshot is the result."""
    cfg_t, cfg_j = (_cfg(tcfg, N=16, nodes=3, max_iters=5),
                    _cfg(jcfg, N=16, nodes=3, max_iters=5))
    pt = tloader.build_problem(cfg_t, "cpu")
    pj = jloader.build_problem(cfg_j)
    res = tadmm.run_admm_snapshots(pt, snapshot_dir=str(tmp_path / "t"),
                                   snapshot_every=2)
    jadmm.run_admm_snapshots(pj, snapshot_dir=str(tmp_path / "j"),
                             snapshot_every=2)
    names = _files(tmp_path / "t")
    assert names == _files(tmp_path / "j")
    assert {n[:9] for n in names} == {"iter_0002", "iter_0004", "iter_0005"}
    last = np.load(tmp_path / "t" / "iter_0005_node_1.npy")
    np.testing.assert_array_equal(last, res.x[1].reshape(16, 16).numpy())
    whole = tadmm.run_admm(pt)
    assert torch.equal(whole.x, res.x)
