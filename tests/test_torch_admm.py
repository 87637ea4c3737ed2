"""The PyTorch port's consensus loop against the JAX package's, on the CPU.

Both packages run from one JAX ``save_problem`` bundle (N=32, P=8,
48 angles, ``fft_skew``, f32 tables) with the torch-op / XLA consensus
(``use_pallas=False``) and a 20-iteration inner budget that keeps the
JAX side's interpret-mode kernels quick. Tolerance: rtol 1e-4 / atol 1e-5
on the history, and atol 1e-5 times the image scale on X, Z and Y (float32
sums taken in another order, compounded over 60 inner iterations); the
acceptance counts must be equal. The consensus options run the same way,
with the fused kernel on (JAX's Pallas kernel in interpret mode, the
port's plain version); the recommended preset (fcv, 15 inner, relax 1.8)
gets JAX's Lanczos start, the same tolerance on X, Z and Y, and rtol 1e-3
on the history (FCV_HIST_RTOL: its stationarity residual g_norm falls to
~0.05 after large terms cancel, in a metric applied by another FFT
library, and comes out 5e-4 apart)."""

import dataclasses

import jax
import jax.numpy as jnp
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

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5
FCV_HIST_RTOL = 1e-3


def _cfg_jax(**over):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(N=32, num_nodes=8, angles_total=48),
        graph=jcfg.GraphConfig(strategy="knn", k=2, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=3, eps_pri=0.0, eps_dual=0.0, use_pallas=False,
            node=jcfg.NodeSolverConfig(max_inner=20, check_every=5),
        ),
        phantom="shepp",
        **over,
    )


def _port_cfg(cfg_j):
    """The same configuration as the port's dataclasses."""
    d = dataclasses.asdict(cfg_j)
    return tcfg.ProblemConfig(
        geometry=tcfg.GeometryConfig(**d["geometry"]),
        graph=tcfg.GraphConfig(**d["graph"]),
        admm=tcfg.AdmmConfig(**{**d["admm"],
                                "node": tcfg.NodeSolverConfig(**d["admm"]["node"])}),
        **{k: v for k, v in d.items() if k not in ("geometry", "graph", "admm")},
    )


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = _cfg_jax()
    problem = jloader.build_problem(cfg, mode="fft_skew")
    path = str(tmp_path_factory.mktemp("bundle") / "problem.npz")
    jser.save_problem(problem, path)
    return cfg, problem, path


@pytest.fixture(scope="module")
def jax_run(bundle):
    cfg, problem, _ = bundle
    return jadmm.run_admm(problem, cfg.admm)


# The recommended operating point on top of the bundle's loop settings.
RECOMMENDED = dict(relax_alpha=1.8, use_pallas=True,
                   node=dict(algorithm="fcv", max_inner=15, check_every=15))


def _over(admm_cfg, over):
    """``admm_cfg`` with the fields of ``over`` replaced (``node`` holds
    node-solver fields)."""
    over = dict(over)
    node = dataclasses.replace(admm_cfg.node, **over.pop("node", {}))
    return dataclasses.replace(admm_cfg, node=node, **over)


def _lanczos_v0():
    """The JAX package's fcv Lanczos start at n = 32 * 32."""
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (32 * 32,), jnp.float32)))


@pytest.fixture(scope="module")
def jax_rec_run(bundle):
    cfg, problem, _ = bundle
    return jadmm.run_admm(problem, _over(cfg.admm, RECOMMENDED))


def _assert_state_close(res_t, res_j, hist_rtol=RTOL):
    # X, Z and Y carry image values (up to 400 here); Y is a difference of
    # two of them, so its absolute tolerance scales with the image.
    scale = float(np.abs(np.asarray(res_j.x)).max())
    for got, want in ((res_t.x, res_j.x), (res_t.state.Z, res_j.state.Z),
                      (res_t.state.Y, res_j.state.Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL * scale)
    assert res_t.n_iters == int(res_j.n_iters)
    assert set(res_t.history) == set(res_j.history)
    for name in ("inner_iters", "accept_code"):
        np.testing.assert_array_equal(res_t.history[name].numpy(),
                                      np.asarray(res_j.history[name]))
    for name, v in res_j.history.items():
        np.testing.assert_allclose(res_t.history[name].numpy(), np.asarray(v),
                                   rtol=hist_rtol, atol=ATOL, err_msg=name)


def test_loaded_bundle_matches(bundle):
    cfg, problem, path = bundle
    tp = tser.load_problem(path, "cpu")
    assert tp.mode == "fft_skew"
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(cfg)
    for k in ("b", "W", "Q", "keep", "adj", "x_true", "opnorm"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(problem, k)))
    x = np.random.default_rng(0).standard_normal(
        (8, 32 * 32)).astype(np.float32)
    np.testing.assert_allclose(
        tp.forward(torch.as_tensor(x)).numpy(),
        np.asarray(problem.forward(jnp.asarray(x))), rtol=1e-4, atol=1e-4)


def test_three_outers_match_jax(bundle, jax_run):
    cfg, _, path = bundle
    tp = tser.load_problem(path, "cpu")
    res_t = tadmm.run_admm(tp, tp.cfg.admm)
    _assert_state_close(res_t, jax_run)


@pytest.mark.parametrize("node_over", [
    dict(warm_start=False), dict(eps_rel=0.02, plateau_tol=0.0),
])
def test_solver_options_match_jax(bundle, node_over):
    """The node-solver options the port implements besides the defaults:
    cold starts, and the data-scale-relative acceptance target."""
    cfg, problem, path = bundle
    jc = dataclasses.replace(
        cfg.admm, node=dataclasses.replace(cfg.admm.node, **node_over))
    res_j = jadmm.run_admm(problem, jc)
    tp = tser.load_problem(path, "cpu")
    tc = dataclasses.replace(
        tp.cfg.admm, node=dataclasses.replace(tp.cfg.admm.node, **node_over))
    _assert_state_close(tadmm.run_admm(tp, tc), res_j)


@pytest.mark.parametrize("cfg_over", [
    dict(use_pallas=True), dict(z_fusion="weighted"), dict(relax_alpha=1.8),
    RECOMMENDED,
], ids=["fused_kernel", "weighted", "relax", "recommended"])
def test_consensus_options_match_jax(bundle, jax_rec_run, cfg_over):
    """Three outers with the fused consensus kernel, weighted fusion,
    over-relaxation, and all of the recommended preset."""
    cfg, problem, path = bundle
    hist_rtol = RTOL
    if cfg_over == RECOMMENDED:
        res_j, hist_rtol = jax_rec_run, FCV_HIST_RTOL
    else:
        res_j = jadmm.run_admm(problem, _over(cfg.admm, cfg_over))
    tp = tser.load_problem(path, "cpu")
    res_t = tadmm.run_admm(tp, _over(tp.cfg.admm, cfg_over),
                           lanczos_v0=_lanczos_v0())
    _assert_state_close(res_t, res_j, hist_rtol)


def test_resume_equals_straight_run(bundle):
    """Under the bundle's settings and under the recommended preset (whose
    fcv step rides in the warm-started state), two outers and then the
    third equal three in one call, bit for bit."""
    _, _, path = bundle
    tp = tser.load_problem(path, "cpu")
    for cfg in (tp.cfg.admm, _over(tp.cfg.admm, RECOMMENDED)):
        straight = tadmm.run_admm(tp, cfg)
        part = tadmm.run_admm(tp, cfg, until=2)
        assert part.n_iters == 2
        assert np.isnan(part.history["primal"][2].item())
        rest = tadmm.run_admm(tp, cfg, state=part.state, hist=part.history,
                              until=3)
        assert rest.n_iters == 3
        np.testing.assert_array_equal(rest.x.numpy(), straight.x.numpy())
        for name in ("tk", "xp"):
            np.testing.assert_array_equal(
                getattr(rest.state.node, name).numpy(),
                getattr(straight.state.node, name).numpy())
        for name, v in straight.history.items():
            np.testing.assert_array_equal(rest.history[name].numpy(),
                                          v.numpy())


def test_stepping_outers_equals_run_admm(bundle):
    """``block_data`` and ``admm_iteration``, one outer at a time (as the
    chip smoke's profile steps them), give what ``run_admm`` gives, bit for
    bit, under the recommended preset."""
    _, _, path = bundle
    tp = tser.load_problem(path, "cpu")
    cfg = _over(tp.cfg.admm, RECOMMENDED)
    straight = tadmm.run_admm(tp, cfg)
    state, hist = tadmm.init_state(tp, cfg)
    data = tadmm.block_data(tp, cfg)
    while state.k < cfg.max_iters:
        state = tadmm.admm_iteration(data, cfg, state, hist)
    np.testing.assert_array_equal(state.node.x.numpy(), straight.x.numpy())
    for name, v in straight.history.items():
        np.testing.assert_array_equal(hist[name].numpy(), v.numpy())


def test_resume_from_jax_state(bundle, jax_run, jax_rec_run):
    """JAX runs two outers; the port continues from JAX's state and
    history (state_from_numpy) and lands where JAX's third outer does,
    under the bundle's settings and under the recommended preset (where
    the state carries fcv's adapted step)."""
    cfg, problem, path = bundle
    tp = tser.load_problem(path, "cpu")
    for over, want, hist_rtol in (({}, jax_run, RTOL),
                                  (RECOMMENDED, jax_rec_run, FCV_HIST_RTOL)):
        part = jadmm.run_admm(problem, _over(cfg.admm, over), until=2)
        st, hist = tadmm.state_from_numpy(part.state, part.history, "cpu")
        assert st.k == 2
        res_t = tadmm.run_admm(tp, _over(tp.cfg.admm, over), state=st,
                               hist=hist, lanczos_v0=_lanczos_v0())
        _assert_state_close(res_t, want, hist_rtol)
        np.testing.assert_allclose(res_t.state.node.tk.numpy(),
                                   np.asarray(want.state.node.tk), rtol=1e-4)


def test_history_helpers():
    h = tadmm.make_history(4, 3, "cpu")
    assert [n for n, _ in tadmm.HISTORY_FIELDS] == [
        n for n, _ in jadmm.HISTORY_FIELDS]
    assert len(h) == 16 and h["g_norm"].shape == (4, 3)
    assert torch.isnan(h["primal"]).all()
    g = tadmm.grow_history(h, 6)
    assert g["primal"].shape == (6,) and g["inner_iters"].shape == (6, 3)
    assert tadmm.grow_history(g, 2)["primal"].shape == (6,)


@pytest.mark.parametrize("cfg_over", [
    dict(node=dict(algorithm="newton")),
    dict(adapt_rho=True, adapt_rho_mode="spectral"),
], ids=["algorithm", "adapt_rho_mode"])
def test_unknown_options_raise(bundle, cfg_over):
    """The JAX package's ValueErrors: an unknown inner algorithm, an
    unknown adapt_rho_mode."""
    cfg, problem, path = bundle
    with pytest.raises(ValueError):
        jadmm.run_admm(problem, _over(cfg.admm, cfg_over))
    tp = tser.load_problem(path, "cpu")
    with pytest.raises(ValueError):
        tadmm.run_admm(tp, _over(tp.cfg.admm, cfg_over))


@pytest.mark.parametrize("noise_level", [0.0, 0.005])
def test_port_build_matches_jax(noise_level):
    """With JAX's noise draw and power-method start passed in, the port's
    own problem build gives JAX's b, W, graph and opnorm."""
    cfg_j = _cfg_jax(noise_level=noise_level)
    cfg_j = dataclasses.replace(
        cfg_j, geometry=dataclasses.replace(cfg_j.geometry, num_nodes=4))
    pj = jloader.build_problem(cfg_j, mode="fft_skew")
    P, n = 4, 32 * 32
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (P, n),
                                      dtype=jnp.float32))
    noise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(cfg_j.noise_seed), pj.b.shape, jnp.float32))
    pt = tloader.build_problem(_port_cfg(cfg_j), "cpu", mode="fft_skew",
                               noise=torch.as_tensor(np.array(noise)),
                               opnorm_v0=torch.as_tensor(np.array(v0)))
    scale = np.abs(np.asarray(pj.b)).max()
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(pt.W.numpy(), np.asarray(pj.W), rtol=1e-5,
                               atol=1e-5 * np.asarray(pj.W).max())
    np.testing.assert_array_equal(pt.keep.numpy(), np.asarray(pj.keep))
    np.testing.assert_array_equal(pt.adj.numpy(), np.asarray(pj.adj))
    np.testing.assert_allclose(pt.opnorm.numpy(), np.asarray(pj.opnorm),
                               rtol=1e-4)
