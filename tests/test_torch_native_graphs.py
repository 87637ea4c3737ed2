"""The port's native per-pixel graph builder (``graph/native.py``, a ctypes
binding of ``native/pixel_graphs.cpp``) on the CPU: masks equal to the
port's torch build and to the JAX package's native builder, exactly, for
knn k = 1, 2, 3 and mst, on random weights (P = 6 nodes, 300 pixels) with
ties (a third of the pixels' weights rounded to one decimal, others all at
the precision floor, as pixels outside the support are)."""

import numpy as np
import pytest
import torch

from dip_admm_tpu.graph import native as jnative
from dip_admm_tpu_torch.graph import native, precisions, topology
from dip_admm_tpu_torch.utils import _native

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no g++ with OpenMP on this host")


def _q(q_mode="arithmetic", P=6, n=300, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.1, 2.0, size=(P, n)).astype(np.float32)
    W[:, : n // 3] = np.round(W[:, : n // 3], 1)
    W[:, -20:] = precisions.EPS
    return precisions.pairwise_q(torch.as_tensor(W), q_mode)


CASES = [("knn", 1), ("knn", 2), ("knn", 3), ("mst", 0)]


@pytest.mark.parametrize("strategy, k", CASES)
@pytest.mark.parametrize("q_mode", ["arithmetic", "harmonic"])
def test_native_matches_torch_and_jax(strategy, k, q_mode):
    q = _q(q_mode)
    got = native.build_pixel_masks_native(q, strategy=strategy, k=k)
    want = topology.build_pixel_masks(q, strategy=strategy, k=k).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.build_pixel_masks_native(q.numpy(), strategy=strategy,
                                              k=k))


def test_native_structure_and_build_place():
    """Symmetric masks, P - 1 edges a pixel under mst; the library lies in
    ``build/native/``, not beside its source."""
    keep = native.build_pixel_masks_native(_q("harmonic").numpy(), "mst")
    assert (keep.sum(axis=(0, 1)) // 2 == 5).all()
    assert (keep == keep.transpose(1, 0, 2)).all()
    assert not keep[np.arange(6), np.arange(6)].any()
    path = _native.lib_path("pixel_graphs")
    assert path.parent == _native.BUILD_DIR and path.exists()
    assert native.num_threads() >= 1


def test_native_refuses_other_strategies():
    with pytest.raises(ValueError, match="chain"):
        native.build_pixel_masks_native(_q(), strategy="chain")
