"""``fold_eval`` (the irfft, hat evaluation and branch scale folded into the
WC tables of ``fft_grouped``) in the PyTorch port against the JAX package,
on the CPU, at N = 32 with 3 nodes (a padded angle row), on numpy-seeded
inputs. On the CPU K13/K14 run their plain versions.

Tolerances: WC tables to 1e-5 of their max in f32 and one bf16 ulp beyond
that in bf16 (sums over v in another order before the rounding); the
folded operators to 1e-4 of the output's max with f32 tables and 2e-3 with
bf16 tables (as ``test_torch_fan.py``'s grouped operators); the folded
pair to 1e-5 of the unfolded pair's max with f32 tables (the same
operator) and 1e-2 with bf16 (WC rounded to bf16 against the f32 irfft
rows, and the spectra rounded to bf16); the adjoint identity to 1e-5
relative with f32 WC."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dip_admm_tpu.ops import radon_fft as jfft
from dip_admm_tpu_torch.ops import radon_fft as tfft

from test_torch_fan import _adjoint_rel, _angles, _geos, _inputs
from test_torch_matrix_free import _assert_tables_match

torch.set_num_threads(2)

OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
FOLD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
GEO = dict(N=32, num_nodes=3, angles_total=31)


def _build(dtype_name, fold_eval=True):
    gt, gj = _geos(**GEO)
    at, vt, aj, vj = _angles(gt)
    tt = tfft.precompute_grouped(gt, at, vt, getattr(torch, dtype_name),
                                 fold_eval=fold_eval)
    tj = jfft.precompute_grouped(gj, aj, vj, jnp.dtype(dtype_name),
                                 fold_eval=fold_eval)
    return gt, gj, tt, tj


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def folded(request):
    return request.param, _build(request.param)


def test_wc_tables_match_jax(folded):
    _, (_, _, tt, tj) = folded
    assert "WCre" in tt and "WCim" in tt
    assert tt["WCre"].is_contiguous()
    _assert_tables_match({k: tt[k] for k in ("WCre", "WCim")},
                         {k: tj[k] for k in ("WCre", "WCim")})


def test_folded_operators_match_jax(folded):
    dtype_name, (gt, gj, tt, tj) = folded
    x, y = _inputs(gt, seed=2)
    tol = OP_RTOL[dtype_name]
    want = np.asarray(jfft.project_nodes_grouped(gj, jnp.asarray(x), tj))
    got = tfft.project_nodes_grouped(gt, torch.as_tensor(x), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    want_t = np.asarray(jfft.backproject_nodes_grouped(gj, jnp.asarray(y), tj))
    got_t = tfft.backproject_nodes_grouped(gt, torch.as_tensor(y), tt).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=0,
                               atol=tol * np.abs(want_t).max())


def test_folded_pair_matches_unfolded(folded):
    """The folded tail computes the unfolded one's operator."""
    dtype_name, (gt, _, tt, _) = folded
    plain = {k: v for k, v in tt.items() if k not in ("WCre", "WCim")}
    x, y = (torch.as_tensor(a) for a in _inputs(gt, seed=3))
    for fn, arg in ((tfft.project_nodes_grouped, x),
                    (tfft.backproject_nodes_grouped, y)):
        want = fn(gt, arg, plain)
        got = fn(gt, arg, tt)
        torch.testing.assert_close(
            got, want, rtol=0,
            atol=FOLD_RTOL[dtype_name] * float(want.abs().max()))


def test_folded_adjoint_identity():
    gt, _, tt, _ = _build("float32")
    x, y = _inputs(gt, seed=4)
    rel = _adjoint_rel(lambda v: tfft.project_nodes_grouped(gt, v, tt),
                       lambda v: tfft.backproject_nodes_grouped(gt, v, tt),
                       x, y)
    assert rel < 1e-5, rel


def test_fold_respects_the_byte_cap(monkeypatch):
    """Past ``_FOLD_EVAL_MAX_BYTES`` of WC the fold is dropped, as in the
    JAX package (the cap set just below this problem's WC bytes in both);
    off by default."""
    gt, gj, tt, _ = _build("float32")
    wc = 2 * tt["WCre"].numel() * 4
    monkeypatch.setattr(tfft, "_FOLD_EVAL_MAX_BYTES", wc - 1)
    monkeypatch.setattr(jfft, "_FOLD_EVAL_MAX_BYTES", wc - 1)
    at, vt, aj, vj = _angles(gt)
    capped = tfft.precompute_grouped(gt, at, vt, fold_eval=True)
    capped_j = jfft.precompute_grouped(gj, aj, vj, fold_eval=True)
    assert "WCre" not in capped and "WCre" not in capped_j
    monkeypatch.setattr(tfft, "_FOLD_EVAL_MAX_BYTES", wc)
    assert "WCre" in tfft.precompute_grouped(gt, at, vt, fold_eval=True)
    assert "WCre" not in tfft.precompute_grouped(gt, at, vt)
