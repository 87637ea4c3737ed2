"""Problem bundles and checkpoints across the two packages, on the CPU.

- JAX to the port: JAX's ``save_problem`` of ``fft_grouped``,
  ``fft_pallas``, fan ``fft_skew`` and fan ``fft_grouped`` (32^2, f32 and
  bf16 tables; JAX's kernels in interpret mode) loads in the port, its
  pitched tables laid out as the port's own builds lay them out; the
  loaded problem's forward and adjoint applies within the operator
  tolerance of each mode's port tests (1e-4 of the output's max with f32
  tables, 2e-3 with bf16) of JAX's on the same inputs.
- The port to JAX: JAX's ``load_problem`` reads the port's ``save_problem``
  of every mode the port builds, in both beams where it builds them: every
  array bit for bit (bf16 tables included) and the config equal.
- Checkpoints, both ways: three outers in one package, a checkpoint, three
  more in the other; the result within 1e-4 (states) and 1e-3
  (histories) of a six-outer run of the other package, the tolerances of
  ``test_*_recommended_three_outers_match_jax``. A segmented port run
  (``checkpoint_every=2``) equals an unsegmented one bit for bit.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu_torch import config as tcfg
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops.kernels import filter_sum as tfs
from dip_admm_tpu_torch.runners import experiment as texp
from dip_admm_tpu_torch.utils import native_checkpoint

torch.set_num_threads(2)

OP_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
STATE_RTOL, STATE_ATOL, HIST_RTOL = 1e-4, 1e-5, 1e-3
PARALLEL = dict(N=32, num_nodes=3, angles_total=30)
FAN = dict(N=32, num_nodes=2, angles_total=64, fan_beam=True)


def _cfg(pkg, geo, table_dtype="float32", **admm):
    return pkg.ProblemConfig(
        geometry=pkg.GeometryConfig(**geo),
        graph=pkg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=pkg.AdmmConfig(**admm), phantom="shepp",
        fft_table_dtype=table_dtype)


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _bits(a) -> np.ndarray:
    """The array's bytes, as unsigned integers of its width."""
    a = a.detach().contiguous() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != bool else a


# ---------------------------------------------------------------------------
# JAX bundles loaded by the port.


JAX_BUNDLES = {
    "fft_grouped": (PARALLEL, "float32"),
    "fft_grouped_bf16": (PARALLEL, "bfloat16"),
    "fft_pallas": (PARALLEL, "float32"),
    "fan_fft_skew": (FAN, "float32"),
    "fan_fft_grouped": (FAN, "float32"),
}


@pytest.mark.parametrize("case", list(JAX_BUNDLES))
def test_jax_bundle_loads_and_applies(case, tmp_path):
    geo, tdt = JAX_BUNDLES[case]
    mode = case.removeprefix("fan_").removesuffix("_bf16")
    cfg_j = _cfg(jcfg, geo, tdt)
    pj = jloader.build_problem(cfg_j, mode=mode)
    path = str(tmp_path / "p.npz")
    jser.save_problem(pj, path)
    pt = tser.load_problem(path, "cpu")
    assert pt.mode == mode
    assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(cfg_j)
    for k in ("b", "W", "Q", "keep", "adj", "x_true", "opnorm", "angles"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    # The streams of K11-K14 read pitched rows, as the port's builds give.
    t = pt.fft_tables.get("shared", {}).get("par", pt.fft_tables)
    for key in ("Hre", "Hre_g", "Ere") if mode != "fft_skew" else ():
        if key in t:
            assert tfs.padded(t[key]).shape[-1] % tfs.PITCH == 0, key
    g = cfg_j.geometry
    rng = np.random.default_rng(1)
    P, m = pj.b.shape[0], pj.b.shape[1] // g.n_det
    x = rng.standard_normal((P, g.n)).astype(np.float32)
    r = rng.standard_normal((P, m * g.n_det)).astype(np.float32)
    for got, want in ((pt.forward(torch.as_tensor(x)), pj.forward(x)),
                      (pt.adjoint(torch.as_tensor(r)), pj.adjoint(r))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=OP_RTOL[tdt] * np.abs(want).max())


# ---------------------------------------------------------------------------
# The port's bundles loaded by JAX.


PORT_BUNDLES = {
    **{m: (PARALLEL, m) for m in ("dense", "joseph", "fft_skew",
                                  "fft_grouped", "fft_pallas", "fft_shear",
                                  "fft_mxu")},
    **{f"fan_{m}": (FAN, m) for m in ("dense", "joseph", "fft_skew",
                                      "fft_grouped")},
}


@pytest.mark.parametrize("case", list(PORT_BUNDLES))
def test_port_bundle_loads_in_jax(case, tmp_path):
    geo, mode = PORT_BUNDLES[case]
    geo = dict(geo, N=16) if mode in ("dense", "joseph") else geo
    pt = tloader.build_problem(_cfg(tcfg, geo, "bfloat16"), "cpu", mode=mode)
    path = str(tmp_path / "p.npz")
    tser.save_problem(pt, path)
    pj = jser.load_problem(path)
    assert pj.mode == mode
    assert dataclasses.asdict(pj.cfg) == dataclasses.asdict(pt.cfg)
    names = ("angles", "angle_valid", "b", "W", "Q", "keep", "adj", "x_true",
             "opnorm")
    for k in names:
        np.testing.assert_array_equal(_bits(np.asarray(getattr(pj, k))),
                                      _bits(getattr(pt, k)), err_msg=k)
    if mode == "dense":
        np.testing.assert_array_equal(_bits(np.asarray(pj.A)), _bits(pt.A))
    if not mode.startswith("fft"):
        assert pj.fft_tables is None
        return
    ft, fj = _flat(pt.fft_tables), _flat(pj.fft_tables)
    assert set(ft) == set(fj)
    n_bf16 = 0
    for k, v in ft.items():
        w = np.asarray(fj[k])
        assert w.shape == tuple(v.shape), k
        n_bf16 += v.dtype == torch.bfloat16
        assert (w.dtype == ml_dtypes.bfloat16) == (v.dtype == torch.bfloat16)
        np.testing.assert_array_equal(_bits(w), _bits(v), err_msg=k)
    assert n_bf16 > 0


def test_port_bundle_round_trip_keeps_the_pitch(tmp_path):
    """The port's fft_pallas bundle, loaded back by the port: equal tables,
    pitched again, and the same applies bit for bit."""
    pt = tloader.build_problem(_cfg(tcfg, PARALLEL), "cpu", mode="fft_pallas")
    path = str(tmp_path / "p.npz")
    tser.save_problem(pt, path)
    back = tser.load_problem(path, "cpu")
    for k, v in _flat(pt.fft_tables).items():
        got = _flat(back.fft_tables)[k]
        assert got.stride() == v.stride(), k
        assert torch.equal(got, v), k
    x = torch.randn((3, 32 * 32), generator=torch.Generator().manual_seed(0))
    assert torch.equal(back.forward(x), pt.forward(x))


# ---------------------------------------------------------------------------
# Checkpoints.


@pytest.fixture(scope="module")
def dense_pair(tmp_path_factory):
    """One JAX dense problem (24^2, 3 nodes, cv at 50 inner) as a bundle,
    loaded by the port."""
    geo = dict(N=24, num_nodes=3, angles_total=30)
    cfg_j = _cfg(jcfg, geo, max_iters=6, eps_pri=0.0, eps_dual=0.0,
                 node=jcfg.NodeSolverConfig(max_inner=50))
    pj = jloader.build_problem(cfg_j, mode="dense")
    path = str(tmp_path_factory.mktemp("bundle") / "dense.npz")
    jser.save_problem(pj, path)
    return cfg_j, pj, tser.load_problem(path, "cpu")


def _assert_close(got_x, got_state, got_hist, want_x, want_state, want_hist):
    scale = float(np.abs(np.asarray(want_x)).max())
    for g, w in ((got_x, want_x), (got_state.Z, want_state.Z),
                 (got_state.Y, want_state.Y)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=STATE_RTOL, atol=STATE_ATOL * scale)
    for name, w in want_hist.items():
        np.testing.assert_allclose(np.asarray(got_hist[name]),
                                   np.asarray(w), rtol=HIST_RTOL,
                                   atol=STATE_ATOL, err_msg=name)


def test_jax_checkpoint_resumes_in_the_port(dense_pair, tmp_path):
    cfg_j, pj, pt = dense_pair
    whole = tadmm.run_admm(pt, pt.cfg.admm)
    half = jadmm.run_admm(pj, cfg_j.admm, until=3)
    path = str(tmp_path / "ckpt.npz")
    jser.save_checkpoint(path, half.state, half.history)
    state, hist = tser.load_checkpoint(path, "cpu")
    assert state.k == 3
    res = tadmm.run_admm(pt, pt.cfg.admm, state=state, hist=hist)
    assert res.n_iters == 6
    _assert_close(res.x, res.state, res.history, whole.x, whole.state,
                  whole.history)


def test_port_checkpoint_resumes_in_jax(dense_pair, tmp_path):
    cfg_j, pj, pt = dense_pair
    whole = jadmm.run_admm(pj, cfg_j.admm)
    half = tadmm.run_admm(pt, pt.cfg.admm, until=3)
    path = str(tmp_path / "ckpt.npz")
    tser.save_checkpoint(path, half.state, half.history)
    state, hist = jser.load_checkpoint(path)
    assert int(state.k) == 3
    res = jadmm.run_admm(pj, cfg_j.admm, state=state, hist=hist)
    assert int(res.n_iters) == 6
    _assert_close(res.x, res.state, res.history, whole.x, whole.state,
                  whole.history)


def test_segmented_run_equals_unsegmented(dense_pair, tmp_path):
    """run_one_strategy with checkpoint_every=2 (6 outers, three segments,
    the native packer or numpy writing each checkpoint) gives the one-run
    result bit for bit, and its last checkpoint holds that state; a resume
    from it at k = 6 runs nothing more."""
    _, _, pt = dense_pair
    out = str(tmp_path)
    x1, h1, _ = texp.run_one_strategy(pt.cfg, out, problem=pt,
                                      write_artifacts=False, device="cpu")
    x2, h2, s2 = texp.run_one_strategy(pt.cfg, out, problem=pt,
                                       write_artifacts=False, device="cpu",
                                       checkpoint_every=2)
    np.testing.assert_array_equal(x2, x1)
    for name in h1:
        np.testing.assert_array_equal(h2[name], h1[name], err_msg=name)
    ckpt = os.path.join(s2["out_dir"], "checkpoint.npz")
    state, hist = tser.load_checkpoint(ckpt, "cpu")
    assert state.k == 6
    np.testing.assert_array_equal(state.node.x.numpy(), x1)
    x3, _, s3 = texp.run_one_strategy(pt.cfg, out, problem=pt,
                                      write_artifacts=False, device="cpu",
                                      checkpoint_every=2, resume=ckpt)
    assert s3["n_iters"] == 6
    np.testing.assert_array_equal(x3, x1)


def test_async_checkpoint_round_trip(dense_pair, tmp_path):
    """save_checkpoint_async (the native packer where g++ and zlib are
    there) and flush: the state and history read back bit for bit."""
    _, _, pt = dense_pair
    res = tadmm.run_admm(pt, pt.cfg.admm, until=2)
    path = str(tmp_path / "a.npz")
    tser.save_checkpoint_async(path, res.state, res.history)
    tser.flush_checkpoints()
    assert tser.checkpoint_writer() == (
        "native" if native_checkpoint.available() else "numpy")
    state, hist = tser.load_checkpoint(path, "cpu")
    for got, want in zip(state.node, res.state.node):
        assert torch.equal(got, want)
    assert (state.k, state.stop) == (res.state.k, res.state.stop)
    assert torch.equal(state.rho_scale, res.state.rho_scale)
    for name, v in res.history.items():
        assert torch.equal(hist[name].isnan(), v.isnan()), name
        assert torch.equal(hist[name].nan_to_num(), v.nan_to_num()), name


def test_old_checkpoint_fields_backfill(dense_pair, tmp_path):
    """A checkpoint without xp, tk, rho_scale and the rho history (written
    before they existed): neutral values, the history NaN."""
    _, _, pt = dense_pair
    res = tadmm.run_admm(pt, pt.cfg.admm, until=1)
    payload = tser._checkpoint_payload(res.state, res.history)
    for k in ("xp", "tk", "rho_scale", "hist_rho"):
        payload.pop(k)
    path = str(tmp_path / "old.npz")
    np.savez(path, **payload)
    state, hist = tser.load_checkpoint(path, "cpu")
    assert torch.equal(state.node.xp, torch.zeros_like(state.node.x))
    assert torch.isinf(state.node.tk).all()
    assert float(state.rho_scale) == 1.0
    assert hist["rho"].shape == res.history["rho"].shape
    assert torch.isnan(hist["rho"]).all()


@pytest.mark.parametrize("kw", [dict(checkpoint_every=0),
                                dict(checkpoint_every=-1),
                                dict(snapshot_every=0),
                                dict(checkpoint_every=1, snapshot_every=1),
                                dict(resume="ckpt.npz")])
def test_segment_options_are_checked(dense_pair, kw):
    _, _, pt = dense_pair
    with pytest.raises(ValueError, match="every|resume"):
        texp.run_one_strategy(pt.cfg, "unused", problem=pt, device="cpu",
                              write_artifacts=False, **kw)

