"""Per-pixel communication graphs, batched over the pixel axis.

Four strategies, as in the JAX package:

- ``knn``: top-k neighbours per node on the symmetrized weights,
  OR-symmetrized; if a pixel's graph is disconnected, the full
  maximum-spanning-tree edge set of its complete graph is OR-ed in.
- ``mst``: the maximum spanning tree of each pixel's complete weighted
  graph (Prim's algorithm).
- ``chain``: a path through the nodes in a random order per pixel.
- ``complete``: every pair of nodes.

Every helper takes a batch of pixels ``qp [n, P, P]`` at once, so the
65,536 pixels of a 256^2 image are one tensor program, not a Python loop.

Ties break toward the lower index, as ``jax.lax.top_k`` and ``jnp.argmax``
do in the JAX package: the top-k comes from a stable descending sort, and
``torch.argmax`` returns the first maximum. Ties are real here: pixels
whose column norms all sit at the ``EPS`` clamp have equal q values.

The chain's node orders are an argument (``orders [n, P]``): the JAX
package draws them with ``jax.random``, which torch cannot reproduce, so a
caller that must build JAX's graph passes JAX's orders. Without them the
port draws its own (:func:`chain_orders`), deterministic for a seed but
not JAX's.

``keep[i, j, p]`` is boolean with the pixel axis last, symmetric in (i, j),
with a zero diagonal.
"""

from __future__ import annotations

import torch


def _connected_from_adj(adj: torch.Tensor) -> torch.Tensor:
    """Connectivity of each undirected adjacency in ``adj [n, P, P]`` by
    repeated squaring of (adj | I). Returns [n] bool."""
    P = adj.shape[-1]
    eye = torch.eye(P, dtype=torch.bool, device=adj.device)
    reach = adj | eye
    for _ in range(max(1, P.bit_length())):
        r = reach.to(torch.float32)
        reach = torch.matmul(r, r) > 0
    return reach[:, 0].all(dim=-1)


def _prim_max_tree(qp: torch.Tensor) -> torch.Tensor:
    """Maximum spanning tree of each complete graph with weights
    ``qp [n, P, P]`` (symmetric, zero diagonal), by Prim's algorithm run on
    all pixels at once. Returns the symmetric adjacency [n, P, P]."""
    n, P, _ = qp.shape
    rows = torch.arange(n, device=qp.device)
    in_tree = torch.zeros((n, P), dtype=torch.bool, device=qp.device)
    in_tree[:, 0] = True
    adj = torch.zeros((n, P, P), dtype=torch.bool, device=qp.device)
    neg = torch.tensor(float("-inf"), dtype=qp.dtype, device=qp.device)
    for _ in range(P - 1):
        frontier = in_tree[:, :, None] & ~in_tree[:, None, :]
        score = torch.where(frontier, qp, neg)
        flat = torch.argmax(score.reshape(n, P * P), dim=1)
        u, v = flat // P, flat % P
        adj[rows, u, v] = True
        adj[rows, v, u] = True
        in_tree[rows, v] = True
    return adj


def _knn_adj(qp: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k neighbour selection per node, OR-symmetrized; qp [n, P, P]."""
    n, P, _ = qp.shape
    k_eff = min(k, P - 1)
    adj = torch.zeros((n, P, P), dtype=torch.bool, device=qp.device)
    if k_eff <= 0:
        return adj
    eye = torch.eye(P, dtype=torch.bool, device=qp.device)
    cand = torch.where(eye, torch.tensor(float("-inf"), dtype=qp.dtype,
                                         device=qp.device), qp)
    idx = torch.sort(cand, dim=-1, descending=True, stable=True).indices
    adj.scatter_(2, idx[..., :k_eff], True)
    return adj | adj.transpose(1, 2)


def _knn_then_connect(qp: torch.Tensor, k: int) -> torch.Tensor:
    """knn edges, plus the full max-spanning-tree edge set where the pixel
    graph is disconnected."""
    adj = _knn_adj(qp, k)
    connected = _connected_from_adj(adj)
    if bool(connected.all()):
        return adj
    tree = _prim_max_tree(qp)
    return torch.where(connected[:, None, None], adj, adj | tree)


def chain_orders(n: int, P: int, seed: int = 123) -> torch.Tensor:
    """The port's own node order of each pixel's chain, [n, P] int64: a
    stable argsort of uniform draws from a CPU ``torch.Generator`` seeded
    with ``seed`` (the same orders on every device). They are not the JAX
    package's orders, which come from ``jax.random``."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, P), generator=gen)
    return torch.argsort(u, dim=1, stable=True)


def _chain_adj(orders: torch.Tensor) -> torch.Tensor:
    """Path adjacency [n, P, P] along each pixel's node order
    ``orders [n, P]``."""
    n, P = orders.shape
    adj = torch.zeros((n, P, P), dtype=torch.bool, device=orders.device)
    rows = torch.arange(n, device=orders.device)[:, None]
    adj[rows, orders[:, :-1], orders[:, 1:]] = True
    return adj | adj.transpose(1, 2)


STRATEGIES = ("knn", "mst", "chain", "complete")


def build_pixel_masks(q: torch.Tensor, strategy: str = "knn", k: int = 2,
                      seed: int = 123,
                      orders: torch.Tensor | None = None) -> torch.Tensor:
    """keep[i, j, p] for every pixel, from weights q [P, P, n]. The weights
    are symmetrized and diagonal-zeroed first. ``seed`` and ``orders``
    [n, P] (each row a permutation of the nodes) are the chain's: with
    ``orders`` the chain follows them, else :func:`chain_orders`."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    P, n = q.shape[0], q.shape[-1]
    eye = torch.eye(P, dtype=torch.bool, device=q.device)
    if strategy == "chain":
        if orders is None:
            orders = chain_orders(n, P, seed)
        orders = torch.as_tensor(orders, device=q.device).long()
        if orders.shape != (n, P):
            raise ValueError(f"chain orders must be [{n}, {P}], got "
                             f"{tuple(orders.shape)}")
        masks = _chain_adj(orders)
    elif strategy == "complete":
        masks = (~eye).expand(n, P, P)
    else:
        q_sym = 0.5 * (q + q.transpose(0, 1))
        q_sym = q_sym * (~eye)[:, :, None]
        qp = q_sym.permute(2, 0, 1).contiguous()  # [n, P, P]
        masks = (_knn_then_connect(qp, k) if strategy == "knn"
                 else _prim_max_tree(qp))
    keep = masks.permute(1, 2, 0)  # [P, P, n]
    return (keep | keep.transpose(0, 1)).contiguous()


def union_adjacency(keep: torch.Tensor) -> torch.Tensor:
    """Union node graph over pixels: adj[i, j] = any_p keep[i, j, p]."""
    return torch.any(keep, dim=-1)


def union_summary(keep: torch.Tensor) -> dict:
    """Graph statistics of the union graph, as the JAX CLI reports them."""
    adj = union_adjacency(keep)
    P = adj.shape[0]
    degrees = adj.sum(dim=1)
    return {
        "num_nodes": P,
        "num_edges": int(adj.sum()) // 2,
        "connected": bool(_connected_from_adj(adj[None])[0]),
        "degree_min": int(degrees.min()),
        "degree_mean": float(degrees.float().mean()),
        "degree_max": int(degrees.max()),
        "active_ratio": float(keep.float().mean()),
    }
