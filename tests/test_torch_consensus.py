"""The port's fused consensus update (K5) against the JAX package's, on the
CPU: the port's ``consensus_update`` (its plain version for CPU tensors)
against the JAX Pallas kernel in interpret mode and its jnp reference, at
P=8 with a random adjacency that masks some pairs, for both fusions, in
its single-device form and in its sharded form (one node x pixel block,
with the explicit a_t and weights of the JAX kernel's contract).
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
                                   atol=1e-6 * np.abs(w).max())


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
