"""The port's per-pixel graphs (``graph/topology.py``: knn, mst, chain,
complete) and the loader's graph and phantom options (``rebuild_graph``,
``per_node_phantoms``, ``phantom_array``), against the JAX package on the
CPU.

The same seeded numpy weights go through both packages. The masks must be
equal exactly: knn, mst and complete on the same q (also where columns tie
at the EPS clamp, so both must break ties toward the lower index), and
chain given JAX's node orders. The invariants of the JAX package's
``tests/test_topology.py`` hold for the port's own graphs, its own chain
draws included. The builds with per-node phantoms or a given phantom array,
given JAX's noise draw: x_true and b within 1e-6 of their max.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.graph import precisions as jprec
from dip_admm_tpu.graph import topology as jtopo
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.graph import precisions as tprec
from dip_admm_tpu_torch.graph import topology as ttopo

torch.set_num_threads(2)

P, n = 5, 60
ROOT = Path(__file__).resolve().parents[1]
BUILD_RTOL = 1e-6


def _weights(tied: bool) -> np.ndarray:
    """W [P, n]: uniform draws; with ``tied`` a third of the pixels have
    every node at the EPS clamp (all q equal) and a third two nodes equal."""
    rng = np.random.default_rng(0)
    W = rng.uniform(0.1, 2.0, size=(P, n)).astype(np.float32)
    if tied:
        W[:, : n // 3] = 1e-12
        W[1, n // 3: 2 * n // 3] = W[3, n // 3: 2 * n // 3]
    return W


def _q(tied=False):
    W = _weights(tied)
    return (tprec.pairwise_q(torch.as_tensor(W), "arithmetic"),
            jprec.pairwise_q(jnp.asarray(W), "arithmetic"))


def jax_chain_orders(seed: int, n_pix: int, nodes: int) -> np.ndarray:
    """JAX's chain node orders ([n, P]), drawn as its build_pixel_masks
    draws them."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(n_pix))
    return np.array(jax.vmap(
        lambda kk: jax.random.permutation(kk, nodes))(keys))


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("strategy", ["knn", "mst", "complete"])
def test_masks_equal_jax(strategy, tied):
    qt, qj = _q(tied)
    got = ttopo.build_pixel_masks(qt, strategy=strategy, k=2).numpy()
    want = np.asarray(jtopo.build_pixel_masks(qj, strategy=strategy, k=2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [5, 123])
def test_chain_masks_equal_jax_given_its_orders(seed):
    qt, qj = _q()
    orders = torch.as_tensor(jax_chain_orders(seed, n, P))
    got = ttopo.build_pixel_masks(qt, strategy="chain", seed=seed,
                                  orders=orders).numpy()
    want = np.asarray(jtopo.build_pixel_masks(qj, strategy="chain",
                                              seed=seed))
    np.testing.assert_array_equal(got, want)


def test_committed_chain_orders_are_jax_draws():
    """``scripts/chain_orders_64x5_seed123.npy``, which the card smoke
    hands to the port for the flagship's chain, is JAX's draw."""
    got = np.load(ROOT / "scripts" / "chain_orders_64x5_seed123.npy")
    assert got.dtype == np.int8 and got.shape == (4096, 5)
    np.testing.assert_array_equal(got, jax_chain_orders(123, 4096, 5))


def _connected(adj):
    reach = adj | np.eye(P, dtype=bool)
    for _ in range(P):
        reach = reach @ reach
    return reach[0].all()


@pytest.mark.parametrize("strategy", ["knn", "mst", "chain", "complete"])
def test_masks_symmetric_connected(strategy):
    keep = ttopo.build_pixel_masks(_q()[0], strategy=strategy, k=2).numpy()
    assert keep.shape == (P, P, n) and keep.dtype == bool
    assert (keep == keep.transpose(1, 0, 2)).all()
    assert not keep[np.arange(P), np.arange(P), :].any()
    for p in range(n):
        assert _connected(keep[:, :, p]), f"pixel {p} ({strategy})"


@pytest.mark.parametrize("strategy", ["mst", "chain"])
def test_tree_edge_counts(strategy):
    keep = ttopo.build_pixel_masks(_q(True)[0], strategy=strategy,
                                   seed=1).numpy()
    assert (keep.sum(axis=(0, 1)) // 2 == P - 1).all()


def test_complete_has_every_pair():
    keep = ttopo.build_pixel_masks(_q()[0], strategy="complete").numpy()
    assert (keep.sum(axis=(0, 1)) // 2 == P * (P - 1) // 2).all()


def test_chain_is_path_and_deterministic():
    qt = _q()[0]
    keep = ttopo.build_pixel_masks(qt, strategy="chain", seed=5).numpy()
    deg = keep.sum(axis=1)  # [P, n]
    assert ((deg == 1).sum(axis=0) == 2).all()
    assert ((deg == 2).sum(axis=0) == P - 2).all()
    again = ttopo.build_pixel_masks(qt, strategy="chain", seed=5).numpy()
    other = ttopo.build_pixel_masks(qt, strategy="chain", seed=6).numpy()
    assert (keep == again).all() and (keep != other).any()
    orders = ttopo.chain_orders(n, P, 5)
    assert (torch.sort(orders, dim=1).values == torch.arange(P)).all()


def test_chain_rejects_orders_of_another_shape():
    with pytest.raises(ValueError, match="chain orders"):
        ttopo.build_pixel_masks(_q()[0], strategy="chain",
                                orders=torch.zeros((n, P - 1)))
    with pytest.raises(ValueError, match="strategy"):
        ttopo.build_pixel_masks(_q()[0], strategy="ring")


def _kruskal_max(w):
    edges = sorted(((w[i, j], i, j) for i in range(P)
                    for j in range(i + 1, P)), reverse=True)
    parent = list(range(P))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    total = 0.0
    for wt, i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            total += wt
    return total


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_mst_maximizes_weight(tied):
    qt = _q(tied)[0]
    keep = ttopo.build_pixel_masks(qt, strategy="mst").numpy()
    qs = qt.numpy()
    qs = 0.5 * (qs + qs.transpose(1, 0, 2))
    for p in range(0, n, 7):
        w = qs[:, :, p]
        np.testing.assert_allclose((w * keep[:, :, p]).sum() / 2,
                                   _kruskal_max(w), rtol=1e-5)


@pytest.mark.parametrize("strategy", ["knn", "mst", "chain", "complete"])
def test_union_summary_equals_jax(strategy):
    qt, qj = _q()
    orders = jax_chain_orders(123, n, P)
    kt = ttopo.build_pixel_masks(qt, strategy=strategy, k=2,
                                 orders=torch.as_tensor(orders))
    kj = jtopo.build_pixel_masks(qj, strategy=strategy, k=2, seed=123)
    assert ttopo.union_summary(kt) == jtopo.union_summary(kj)


# ---------------------------------------------------------------------------
# The loader's graph and phantom options.


def _cfgs(**graph):
    geo = dict(N=16, num_nodes=3, angles_total=30)
    g = dict(strategy="knn", k=2, seed=123, **graph)
    return (tcfg.ProblemConfig(geometry=tcfg.GeometryConfig(**geo),
                               graph=tcfg.GraphConfig(**g)),
            jcfg.ProblemConfig(geometry=jcfg.GeometryConfig(**geo),
                               graph=jcfg.GraphConfig(**g)))


def test_rebuild_graph_changes_only_the_graph():
    ct, _ = _cfgs()
    p = tloader.build_problem(ct, "cpu")
    g = dataclasses.replace(ct.graph, strategy="mst")
    r = tloader.rebuild_graph(p, g)
    assert r.cfg.graph == g
    assert dataclasses.replace(r.cfg, graph=ct.graph) == p.cfg
    changed = {f.name for f in dataclasses.fields(p)
               if not (getattr(r, f.name) is getattr(p, f.name))}
    assert changed == {"cfg", "Q", "keep", "adj"}
    want = tloader.build_graph_layer(p.W, g.q_mode, "mst", g.k)
    for got, w in zip((r.Q, r.keep, r.adj), want):
        assert torch.equal(got, w)
    assert (r.keep.sum(dim=(0, 1)) // 2 == 2).all()  # a tree of 3 nodes


@pytest.mark.parametrize("what", ["per_node_phantoms", "phantom_list",
                                  "phantom_array"])
def test_phantom_options_match_jax(what):
    """x_true and b of builds with per-node phantoms or given images, on
    JAX's noise draw, within 1e-6 of their max (the Joseph projector)."""
    ct, cj = _cfgs()
    N, nodes = 16, 3
    rng = np.random.default_rng(4)
    kw = {
        "per_node_phantoms": dict(per_node_phantoms=True),
        "phantom_list": dict(phantom_array=[
            rng.uniform(0, 1, (N, N)).astype(np.float32)
            for _ in range(nodes)]),
        "phantom_array": dict(
            phantom_array=rng.uniform(0, 1, (N, N)).astype(np.float32)),
    }[what]
    pj = jloader.build_problem(cj, mode="joseph", **kw)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(cj.noise_seed),
                                       pj.b.shape, jnp.float32))
    pt = tloader.build_problem(ct, "cpu", mode="joseph",
                               noise=torch.as_tensor(noise), **kw)
    for name in ("x_true", "b"):
        want = np.asarray(getattr(pj, name))
        np.testing.assert_allclose(getattr(pt, name).numpy(), want, rtol=0,
                                   atol=BUILD_RTOL * np.abs(want).max(),
                                   err_msg=name)
    if what != "phantom_array":  # the nodes measure different images
        assert not torch.allclose(pt.b[0], pt.b[1])
