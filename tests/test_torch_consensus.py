"""The port's fused consensus update (K5) against the JAX package's, on the
CPU: the port's ``consensus_update`` (its plain version for CPU tensors)
against the JAX Pallas kernel in interpret mode and its jnp reference, at
P=8 with a random adjacency that masks some pairs, for both fusions, in
its single-device form and in its sharded form (one node x pixel block,
with the explicit a_t and weights of the JAX kernel's contract).
A numpy mirror of the card kernel's order (one cluster per unordered pair,
per-block partials, then the cluster's ranks in order) is held to the same
JAX kernel at n = 4096 and at odd n = 3969, on an adjacency that is not
symmetric and with a NaN in a masked pair; its z and y equal the port's
plain version bit for bit.
Tolerance: rtol 1e-6 on z and y (the same elementwise float32 ops, with an
absolute floor of 1e-6 times the output max for values near 0), rtol 1e-5
on the per-pair partials (sums of n squares taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops.pallas import consensus as jcons
from dip_admm_tpu_torch.ops.kernels import consensus as tcons

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _data(n, P=8, seed=0):
    rng = np.random.default_rng(seed)
    a, y, z = (rng.standard_normal((P, P, n)).astype(np.float32)
               for _ in range(3))
    adjm = (rng.random((P, P)) > 0.4).astype(np.float32)
    adjm = np.maximum(adjm, adjm.T)
    np.fill_diagonal(adjm, 0.0)
    assert 0 < adjm.sum() < P * P - P  # some pairs masked, some live
    w = (rng.random((P, n)) + 0.1).astype(np.float32)
    return a, y, z, adjm, w


def _close(got, want):
    for g, w, rtol in zip(got, want, (1e-6, 1e-6, 1e-5, 1e-5)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=1e-6 * np.nanmax(np.abs(w)))


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_matches_jax_kernel_and_reference(fusion, n):
    a, y, z, adjm, w = _data(n)
    got = tcons.consensus_update(*(torch.as_tensor(v) for v in
                                   (a, y, z, adjm, w)), fusion=fusion)
    j = [jnp.asarray(v) for v in (a, y, z, np.swapaxes(a, 0, 1).copy(),
                                  adjm)]
    kern = jcons.consensus_update(*j, jnp.asarray(w), jnp.asarray(w),
                                  fusion=fusion,
                                  tile=jcons.pick_tile(n), interpret=True)
    ref = jcons.consensus_update_reference(*j, jnp.asarray(w),
                                           jnp.asarray(w), fusion=fusion)
    _close(got, kern)
    _close(got, ref)
    assert torch.equal(got[0][adjm == 0], torch.zeros_like(got[0][adjm == 0]))


@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_sharded_form_matches_jax_kernel(fusion):
    """The sharded form: node block 1 of 2 (P_loc = 4 of P = 8), pixel block
    1 of 2, with an explicit a_t, w_own and w_all, against JAX's kernel on
    the same block (interpret mode) and against the single-device update's
    slice of the same block."""
    n = 4096
    a, y, z, adjm, w = _data(n)
    rows, cols = slice(4, 8), slice(n // 2, n)
    a_t = np.swapaxes(a, 0, 1)
    blk = [np.ascontiguousarray(v[rows][..., cols]) for v in (a, y, z, a_t)]
    w_own = np.ascontiguousarray(w[rows, cols])
    w_all = np.ascontiguousarray(w[:, cols])
    got = tcons.consensus_update(
        *(torch.as_tensor(v) for v in blk[:3]), torch.as_tensor(adjm[rows]),
        fusion=fusion, a_t=torch.as_tensor(blk[3]),
        w_own=torch.as_tensor(w_own), w_all=torch.as_tensor(w_all))
    kern = jcons.consensus_update(
        *(jnp.asarray(v) for v in blk), jnp.asarray(adjm[rows]),
        jnp.asarray(w_own), jnp.asarray(w_all), fusion=fusion,
        tile=jcons.pick_tile(n // 2), interpret=True)
    _close(got, kern)
    whole = tcons.consensus_update_ref(
        *(torch.as_tensor(v) for v in (a, y, z, adjm, w)), fusion=fusion)
    for g, full in zip(got[:2], whole[:2]):
        assert torch.equal(g, full[rows][..., cols])


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    a, y, z, adjm, w = (torch.as_tensor(v) for v in _data(256))
    tcons.reset_launch_counts()
    got = tcons.consensus_update(a, y, z, adjm, w, "weighted")
    want = tcons.consensus_update_ref(a, y, z, adjm, w, "weighted")
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    got = tcons.consensus_update(a, y, z, adjm, fusion="weighted",
                                 a_t=a.transpose(0, 1).contiguous(), w_own=w,
                                 w_all=w)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert tcons.launch_counts() == {"consensus_update": 0,
                                     "consensus_update_sharded": 0}


def test_bad_fusion_raises():
    a, y, z, adjm, w = (torch.as_tensor(v) for v in _data(128))
    with pytest.raises(ValueError):
        tcons.consensus_update(a, y, z, adjm, fusion="mean")
    with pytest.raises(ValueError):
        tcons.consensus_update(a, y, z, adjm, fusion="weighted")  # no w
    with pytest.raises(ValueError):  # the sharded form needs w_own, w_all
        tcons.consensus_update(a, y, z, adjm, w, "weighted", a_t=a)


# ---------------------------------------------------------------------------
# A numpy mirror of the card kernel's order (csrc/consensus.cu): one cluster
# of C blocks for each unordered pair {i, j}, i <= j, writing both ordered
# pairs; block r streams its 1/C of the pixels (16-byte steps where
# n % 4 == 0, else one pixel at a time), per-thread sums, a shuffle tree
# over each warp and over the warp partials, then rank 0 adds the C block
# partials in rank order. Elementwise f32 arithmetic as the kernel's
# expressions (the kernel may fuse a product into its sums' adds, so the
# partials are held to JAX at 1e-5, not bit for bit).
# ---------------------------------------------------------------------------

NT, C = 256, 8


def _warp_tree(v):
    """Lane 0's value after the shuffle-down tree over the last axis (32)."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :o] = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _block_sum(per_thread):
    """A block's partial: the tree over each warp, then over the warp
    partials in warp 0 (lanes past the warps read 0)."""
    lanes = np.zeros(32, np.float32)
    lanes[:NT // 32] = _warp_tree(per_thread.reshape(NT // 32, 32))
    return _warp_tree(lanes)


def _cluster_sum(sq):
    """A pair's sum of ``sq`` [n] in the kernel's order."""
    n = sq.shape[0]
    total = np.float32(0.0)
    for r in range(C):
        if n % 4 == 0:  # thread t: steps q0 + t, q0 + t + NT, ..., 4 each
            nq = n // 4
            chunk = -(-nq // C)
            q0, q1 = min(r * chunk, nq), min(min(r * chunk, nq) + chunk, nq)
            steps = np.arange(q0, q1)
            idx = np.full((NT, -(-(q1 - q0) // NT) * 4), -1)
            for k, q in enumerate(steps):
                t, m = k % NT, k // NT
                idx[t, 4 * m:4 * m + 4] = 4 * q + np.arange(4)
        else:  # thread t: pixels p0 + t, p0 + t + NT, ...
            chunk = -(-n // C)
            p0, p1 = min(r * chunk, n), min(min(r * chunk, n) + chunk, n)
            idx = np.full((NT, -(-(p1 - p0) // NT)), -1)
            for k, p in enumerate(range(p0, p1)):
                idx[k % NT, k // NT] = p
        acc = np.zeros(NT, np.float32)
        for col in idx.T:
            live = col >= 0
            acc[live] = acc[live] + sq[col[live]]
        total = np.float32(total + _block_sum(acc))
    return total


def _k5_mirror(a, y, z, adjm, w, fusion):
    P, _, n = a.shape
    zn, yn = np.empty_like(a), np.empty_like(a)
    pri, dz2 = np.zeros((P, P), np.float32), np.zeros((P, P), np.float32)
    for i in range(P):
        for j in range(i, P):
            for p, q in ((i, j),) if i == j else ((i, j), (j, i)):
                av, atv, m = a[p, q], a[q, p], adjm[p, q]
                if fusion == "midpoint":
                    zv = np.float32(0.5) * (av + atv) * m
                else:
                    zv = ((w[p] * av + w[q] * atv) / (w[p] + w[q])) * m
                dp = (av - y[p, q] - zv) * m
                dz = (zv - z[p, q]) * m
                zn[p, q], yn[p, q] = zv, (av - zv) * m
                pri[p, q] = _cluster_sum(dp * dp)
                dz2[p, q] = _cluster_sum(dz * dz)
    return zn, yn, pri, dz2


def _asymmetric(n, nan):
    """_data's inputs with an adjacency that is not symmetric (pairs live
    one way and masked the other) and, with ``nan``, a NaN in a masked
    pair's proposals."""
    a, y, z, _, w = _data(n, seed=7)
    rng = np.random.default_rng(8)
    adjm = (rng.random((8, 8)) > 0.5).astype(np.float32)
    np.fill_diagonal(adjm, 0.0)
    assert np.any(adjm != adjm.T)
    if nan:
        i, j = np.argwhere(adjm == 0)[1]
        a[i, j, 5] = np.nan
    return a, y, z, adjm, w


@pytest.mark.parametrize("case", ["symmetric", "asymmetric", "nan"])
@pytest.mark.parametrize("n", [4096, 3969])  # 3969 = 63^2: the scalar path
@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_cluster_mirror_matches_jax_kernel(fusion, n, case):
    a, y, z, adjm, w = (_data(n) if case == "symmetric"
                        else _asymmetric(n, case == "nan"))
    got = _k5_mirror(a, y, z, adjm, w, fusion)
    ref = tcons.consensus_update_ref(*(torch.as_tensor(v) for v in
                                       (a, y, z, adjm, w)), fusion=fusion)
    for g, r in zip(got[:2], ref[:2]):  # z' and y': bit for bit
        np.testing.assert_array_equal(g, r.numpy())
    j = [jnp.asarray(v) for v in (a, y, z, np.swapaxes(a, 0, 1).copy(),
                                  adjm)]
    kern = jcons.consensus_update(*j, jnp.asarray(w), jnp.asarray(w),
                                  fusion=fusion, tile=jcons.pick_tile(n),
                                  interpret=True)
    _close([torch.as_tensor(g) for g in got], kern)
    if case == "nan":  # the masked pair and its transpose carry the NaN
        i, jj = np.argwhere(np.isnan(a[..., 5]))[0]
        assert np.isnan(got[0][i, jj, 5]) and np.isnan(got[0][jj, i, 5])
        assert np.isnan(got[2][i, jj]) and np.isnan(got[2][jj, i])
