"""Problem build of the PyTorch port against the JAX package, on the CPU:
phantoms, angle split, planner, projector tables, column norms and the
per-pixel graph, at N=32, P=3 with 16-row blocks (NB=2)."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.ops import phantoms as jph
from dip_admm_tpu.ops import radon as jradon
from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu.ops.pallas import filter_mxu as jmxu
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.ops import phantoms as tph
from dip_admm_tpu_torch.ops import radon as tradon
from dip_admm_tpu_torch.ops import radon_fft as tfft
from dip_admm_tpu_torch.ops.kernels import filter_mxu as tmxu

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _geos(N=32, P=3, angles_total=30):
    t = tcfg.GeometryConfig(N=N, num_nodes=P, angles_total=angles_total)
    return t, jcfg.GeometryConfig(**dataclasses.asdict(t))


def _angles(geo_t):
    a, v, _ = tradon.node_angles(geo_t)
    return (torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(v),
            jnp.asarray(a, jnp.float32), jnp.asarray(v))


def _bf16_within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger magnitude."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(g - w) > ulp * (1 + 1e-6)
    assert not bad.any(), (g[bad][:5], w[bad][:5])


@pytest.mark.parametrize("kind", ["const", "rand", "shepp"])
@pytest.mark.parametrize("N", [32, 45])
def test_phantoms_bit_identical(kind, N):
    np.testing.assert_array_equal(
        tph.make_phantom(kind, N, seed=3), jph.make_phantom(kind, N, seed=3)
    )


@pytest.mark.parametrize("angles_total", [24, 31, 36])
def test_node_angles_bit_identical(angles_total):
    gt, gj = _geos(angles_total=angles_total)
    for a, b in zip(tradon.node_angles(gt), jradon.node_angles(gj)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tradon.detector_centers(32, 2.0),
                                  jradon.detector_centers(32, 2.0))


def test_plan_branch_groups_equal():
    rng = np.random.default_rng(0)
    use_c = rng.random((4, 30)) < 0.4
    valid = rng.random((4, 30)) < 0.9
    kw = dict(tt_candidates=(48, 32, 16, 8))
    a = tmxu.plan_branch_groups(use_c, valid, **kw)
    b = jmxu.plan_branch_groups(use_c, valid, **kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    g = rng.standard_normal((4, a["Tp"], 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tmxu.permute_rows(torch.as_tensor(g),
                          torch.as_tensor(a["posfull"])).numpy(),
        np.asarray(jmxu.permute_rows(jnp.asarray(g),
                                     jnp.asarray(b["posfull"]))),
    )


def _both_tables(dtype_name, angles_total):
    gt, gj = _geos(angles_total=angles_total)
    at, vt, aj, vj = _angles(gt)
    tt = tfft.precompute_shear(gt, at, vt, getattr(torch, dtype_name), nb=16)
    tj = jfft.precompute_shear(gj, aj, vj, jnp.dtype(dtype_name), nb=16)
    return tt, tj


@pytest.mark.parametrize("angles_total", [24, 36])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_precompute_shear_tables_match(dtype_name, angles_total):
    """Integer tables equal, f32 tables to 1e-6, bf16 tables to one ulp."""
    tt, tj = _both_tables(dtype_name, angles_total)
    assert tt["WtT"].shape == tuple(tj["WtT"].shape)
    assert tt["WtT"].shape[1] == 2  # NB = 2 row blocks
    for k in ("plane", "pfirst", "posfull", "invposfull"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]))
    np.testing.assert_array_equal(tt["pvisited"].numpy(),
                                  np.asarray(tj["pvisited"]))
    flat = {k: v for k, v in tt.items() if k != "shared"}
    flat.update(tt["shared"])
    jflat = {k: v for k, v in tj.items() if k != "shared"}
    jflat.update(tj["shared"])
    for k in ("WtT", "SEre", "SEim", "Wd", "TEre", "TEim", "PhiDre",
              "PhiDim", "Dre", "Dim", "DreT", "DimT"):
        got, want = flat[k], np.asarray(jflat[k])
        assert tuple(got.shape) == want.shape, k
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16, k
            _bf16_within_one_ulp(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("angles_total", [24, 36])
def test_colnorms_sq_matches(angles_total):
    gt, gj = _geos(angles_total=angles_total)
    at, vt, aj, vj = _angles(gt)
    for i in range(gt.num_nodes):
        got = tfft.colnorms_sq(gt, at[i], vt[i]).numpy()
        want = np.asarray(jfft.colnorms_sq(gj, aj[i], vj[i]))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _graph_both(W, q_mode="arithmetic"):
    Qt, kt, at = tloader.build_graph_layer(torch.as_tensor(W), q_mode, "knn",
                                           2)
    Qj, kj, aj = jloader._build_graph_layer(jnp.asarray(W), q_mode, "knn", 2,
                                            123)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(Qt.numpy(), np.asarray(Qj))


@pytest.mark.parametrize("q_mode", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("P", [3, 8])
def test_graph_layer_equal(P, q_mode):
    """Q, keep and adj equal the JAX package's, including pixels where every
    W sits at the EPS clamp (tied q values: the lower index wins)."""
    rng = np.random.default_rng(P)
    n = 200
    W = rng.random((P, n)).astype(np.float32) + 0.1
    W[:, :20] = 1e-12  # all at the clamp: every q ties
    W[: P // 2, 20:40] = 1e-12  # half the nodes clamped
    W[:, 40:60] = np.round(W[:, 40:60], 1)  # coarse values: partial ties
    _graph_both(W, q_mode)


def test_graph_layer_equal_on_column_norms():
    gt, gj = _geos()
    at, vt, _, _ = _angles(gt)
    W = tloader.node_colnorms(gt, at, vt).numpy()
    _graph_both(W)
