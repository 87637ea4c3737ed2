"""Scenario batching: the port's ``run_admm_batched`` (the grouped node
solve, the batched operators and K5's batch axis) against the JAX
package's on the CPU.

Both packages run a JAX ``save_problem`` bundle (N=16, 3 nodes, 24 angles)
against one batch of three sinogram sets made with numpy from the bundle's
own, with the torch-op / XLA consensus in the JAX runs (JAX turns its
kernel off under batching) and, in the port, K5's plain version where
``use_pallas`` asks for the kernel. Tolerances, as in the port's other
loop tests: X, Z and Y within rtol 1e-4 / atol 1e-5 of the image scale,
the histories within rtol 1e-3 / atol 1e-5, and the acceptance counts,
outers run and the NaN rows of frozen scenarios equal. The grouped node
solve is held to separate solves of each group, K5's batched plain version
to calls on each lane (bit for bit) and the batched operators of every
mode to each lane's own (Joseph bit for bit, the others within 1e-6 of
the max).
"""

import dataclasses

import _torch_mesh_worker as worker
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
from dip_admm_tpu_torch.core import node_solver as tns
from dip_admm_tpu_torch.data import loader as tloader
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.ops.kernels import consensus as tcons

torch.set_num_threads(2)

STATE_RTOL, STATE_ATOL, HIST_RTOL = 1e-4, 1e-5, 1e-3
N, P = 16, 3


def _cfg(**admm):
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(N=N, num_nodes=P, angles_total=24),
        graph=jcfg.GraphConfig(strategy="knn", k=1, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=3, eps_pri=0.0, eps_dual=0.0, use_pallas=False,
            node=jcfg.NodeSolverConfig(max_inner=20, check_every=5), **admm),
        phantom="shepp",
    )


def _bundle(tmp_path_factory, mode):
    cfg = _cfg()
    pj = jloader.build_problem(cfg, mode=mode)
    path = str(tmp_path_factory.mktemp(mode) / "problem.npz")
    jser.save_problem(pj, path)
    return cfg, pj, tser.load_problem(path, "cpu")


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return _bundle(tmp_path_factory, "dense")


@pytest.fixture(scope="module")
def skew(tmp_path_factory):
    return _bundle(tmp_path_factory, "fft_skew")


def _batch(pj, scales=(1.0, 1.1, 0.9)):
    """Three sinogram sets: the bundle's b scaled, the last with seeded
    noise added (zero on padded angle rows), and their phantoms."""
    b = np.asarray(pj.b)
    rng = np.random.default_rng(4)
    rows = np.repeat(np.asarray(pj.angle_valid), N, axis=1)
    bb = np.stack([s * b for s in scales]).astype(np.float32)
    bb[-1] += (0.5 * rng.standard_normal(b.shape) * rows).astype(np.float32)
    x0 = np.asarray(pj.x_true)
    xt = np.stack([s * x0 for s in scales]).astype(np.float32)
    return bb, xt


def _lanczos_v0():
    return torch.as_tensor(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (N * N,), jnp.float32)))


def _assert_batched_close(res_t, res_j):
    scale = float(np.abs(np.asarray(res_j.x)).max())
    for got, want in ((res_t.x, res_j.x), (res_t.state.Z, res_j.state.Z),
                      (res_t.state.Y, res_j.state.Y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=STATE_RTOL, atol=STATE_ATOL * scale)
    np.testing.assert_array_equal(res_t.n_iters.numpy(),
                                  np.asarray(res_j.n_iters))
    np.testing.assert_array_equal(res_t.state.stop.numpy(),
                                  np.asarray(res_j.state.stop))
    assert set(res_t.history) == set(res_j.history)
    for name, v in res_j.history.items():
        got, want = res_t.history[name].numpy(), np.asarray(v)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=name)
        if name in ("inner_iters", "accept_code"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=HIST_RTOL,
                                   atol=STATE_ATOL, err_msg=name)


CASES = {
    "dense_cv": ("dense", {}),
    "dense_relax_k5": ("dense", {"relax_alpha": 1.8, "use_pallas": True}),
    "dense_adapt_rho": ("dense", {"adapt_rho": True, "rho_mu": 1.5,
                                  "max_iters": 6}),
    "fft_skew_fcv": ("fft_skew", {"relax_alpha": 1.8, "node": {
        "algorithm": "fcv", "max_inner": 15, "check_every": 15}}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_admm_batched_matches_jax(request, case):
    mode, changes = CASES[case]
    cfg, pj, tp = request.getfixturevalue(
        "dense" if mode == "dense" else "skew")
    bb, xt = _batch(pj)
    jc = worker.over(cfg.admm, changes)
    res_j = jadmm.run_admm_batched(pj, jnp.asarray(bb), jnp.asarray(xt), jc)
    v0 = _lanczos_v0() if "node" in changes else None
    res_t = tadmm.run_admm_batched(tp, torch.as_tensor(bb),
                                   torch.as_tensor(xt),
                                   worker.over(tp.cfg.admm, changes),
                                   lanczos_v0=v0)
    assert res_t.x.shape == (3, P, N * N)
    if case == "dense_adapt_rho":  # rho moves, and per scenario
        rho = res_t.history["rho"].numpy()
        assert len(set(rho.ravel().tolist())) >= 3
    _assert_batched_close(res_t, res_j)


# (scale of lane 1's b, eps_pri, eps_dual, the outers each lane runs)
STOP_CASES = {
    "zero_b": (0.0, 1e-3, 1e-3, [4, 1, 4]),
    # lane 1's residuals are ~100x the others' smaller: it meets the
    # targets after 2 outers with a state that would still move
    "scaled_b": (0.01, 0.5, 8.0, [4, 2, 4]),
}


@pytest.mark.parametrize("case", list(STOP_CASES))
def test_scenario_that_stops_early_is_frozen_as_in_jax(dense, case):
    """One lane meets eps_pri/eps_dual before the others (b = 0 at its
    first outer; b scaled 100x down at its second) and stops: its state
    stays, its later history rows stay NaN, and the other lanes run on,
    as under JAX's vmap."""
    cfg, pj, tp = dense
    scale, eps_pri, eps_dual, outers = STOP_CASES[case]
    bb, xt = _batch(pj)
    bb[1] *= scale
    changes = {"eps_pri": eps_pri, "eps_dual": eps_dual, "max_iters": 4}
    res_j = jadmm.run_admm_batched(pj, jnp.asarray(bb), jnp.asarray(xt),
                                   worker.over(cfg.admm, changes))
    res_t = tadmm.run_admm_batched(tp, torch.as_tensor(bb),
                                   torch.as_tensor(xt),
                                   worker.over(tp.cfg.admm, changes))
    assert res_t.n_iters.tolist() == outers
    assert torch.isnan(res_t.history["primal"][1, outers[1]:]).all()
    _assert_batched_close(res_t, res_j)


def test_scenario_whose_inner_loop_ends_first_matches_jax(dense):
    """A lane scaled down 100x meets its stationarity target at fewer inner
    iterations than the others in the same outer: the grouped solve
    freezes it while the others step on, with JAX's counts."""
    cfg, pj, tp = dense
    bb, xt = _batch(pj, scales=(1.0, 0.01, 0.9))
    changes = {"node": {"max_inner": 40, "check_every": 5}}
    res_j = jadmm.run_admm_batched(pj, jnp.asarray(bb), jnp.asarray(xt),
                                   worker.over(cfg.admm, changes))
    res_t = tadmm.run_admm_batched(tp, torch.as_tensor(bb),
                                   torch.as_tensor(xt),
                                   worker.over(tp.cfg.admm, changes))
    inner = res_t.history["inner_iters"].numpy()  # [B, T, P]
    assert (inner.max(axis=2)[1] < inner.max(axis=2)[0]).any()
    _assert_batched_close(res_t, res_j)


@pytest.mark.parametrize("mode", ["dense", "fan_skew"])
def test_batched_lane_equals_its_single_run(request, mode):
    """Each lane of the port's batch against the port's own run_admm on
    that lane's data (1e-5 of the image scale: the batched dense product
    sums in another order): the dense bundle, and fan fft_skew built by
    the port (its node images against one shared table set, PT = 1)."""
    if mode == "dense":
        _, pj, tp = request.getfixturevalue("dense")
        bb, xt = _batch(pj)
    else:
        geo = tcfg.GeometryConfig(N=N, num_nodes=P, angles_total=24,
                                  fan_beam=True, det_width_factor=2.0)
        tp = tloader.build_problem(tcfg.ProblemConfig(
            geometry=geo, phantom="shepp", admm=tcfg.AdmmConfig(
                max_iters=3, eps_pri=0.0, eps_dual=0.0,
                node=tcfg.NodeSolverConfig(max_inner=20, check_every=5))),
            "cpu", mode="fft_skew")
        b = tp.b.numpy()
        bb = np.stack([b, 1.1 * b, 0.9 * b]).astype(np.float32)
        xt = np.stack([s * tp.x_true.numpy() for s in (1.0, 1.1, 0.9)])
    cfg = tp.cfg.admm
    res = tadmm.run_admm_batched(tp, torch.as_tensor(bb), torch.as_tensor(xt),
                                 cfg)
    for s in range(3):
        one = tadmm.run_admm(dataclasses.replace(
            tp, b=torch.as_tensor(bb[s]), x_true=torch.as_tensor(xt[s])), cfg)
        scale = float(one.x.abs().max())
        for got, want in ((res.x[s], one.x), (res.state.Z[s], one.state.Z)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * scale)
        np.testing.assert_array_equal(
            res.history["inner_iters"][s].numpy(),
            one.history["inner_iters"].numpy())


def test_grouped_node_solve_equals_separate_solves(dense):
    """solve_nodes(groups=3) on three stacked problems against three calls
    of one group each: each group's trip count, acceptance and state (the
    groups stop at different checks)."""
    _, pj, tp = dense
    bb, _ = _batch(pj, scales=(1.0, 0.01, 0.5))
    rng = np.random.default_rng(2)
    Q = tp.Q
    D = Q.sum(1)
    node = tcfg.NodeSolverConfig(max_inner=40, check_every=5)
    L = tp.opnorm + 2.0 * D.amax(-1)
    outs = []
    Vs = [torch.as_tensor(rng.random((P, P, N * N), dtype=np.float32))
          * 100.0 * s for s in (1.0, 0.01, 0.5)]
    for s in range(3):
        outs.append(tns.solve_nodes(
            tp.forward, tp.adjoint, torch.as_tensor(bb[s]), D,
            (Q * Vs[s]).sum(1), (Q * Vs[s] ** 2).sum((1, 2)), 0.02, 2.0, L,
            tns.init_state(P, N, tp.m_flat, "cpu"), torch.tensor(0.5), node,
            N))
    cat = lambda f: torch.cat([f(o) for o in outs])  # noqa: E731
    V = torch.cat(Vs)  # [3P, P, n]
    Qb = Q.repeat(3, 1, 1)
    got = tns.solve_nodes(
        tp.forward, tp.adjoint, torch.as_tensor(bb).reshape(3 * P, -1),
        D.repeat(3, 1), (Qb * V).sum(1), (Qb * V ** 2).sum((1, 2)), 0.02,
        2.0, L.repeat(3), tns.init_state(3 * P, N, tp.m_flat, "cpu"),
        torch.tensor(0.5), node, N, groups=3)
    assert got.trip_count.tolist() == [o.trip_count for o in outs]
    assert len(set(got.trip_count.tolist())) > 1
    assert torch.equal(got.inner_iters, cat(lambda o: o.inner_iters))
    assert torch.equal(got.accept_code, cat(lambda o: o.accept_code))
    np.testing.assert_allclose(got.state.x.numpy(),
                               cat(lambda o: o.state.x).numpy(), rtol=0,
                               atol=1e-5 * float(got.state.x.abs().max()))


@pytest.mark.parametrize("fusion", ["midpoint", "weighted"])
def test_consensus_ref_batch_equals_lanes(fusion):
    """K5's plain version on a [B, P, P, n] batch equals its calls on each
    lane bit for bit, and B = 1 equals the unbatched call."""
    rng = np.random.default_rng(7)
    B, Pn, n = 3, 4, 40
    a, y, z = (torch.as_tensor(rng.standard_normal((B, Pn, Pn, n)),
                               dtype=torch.float32) for _ in range(3))
    adjm = torch.as_tensor(rng.random((Pn, Pn)) < 0.6, dtype=torch.float32)
    w = torch.as_tensor(rng.random((Pn, n)) + 0.1, dtype=torch.float32)
    got = tcons.consensus_update(a, y, z, adjm, w, fusion)
    assert [tuple(g.shape) for g in got] == [(B, Pn, Pn, n)] * 2 + [(B, Pn,
                                                                     Pn)] * 2
    for s in range(B):
        want = tcons.consensus_update_ref(a[s], y[s], z[s], adjm, w, fusion)
        for g, wv in zip(got, want):
            assert torch.equal(g[s], wv)
    one = tcons.consensus_update_ref(a[:1], y[:1], z[:1], adjm, w, fusion)
    for g, wv in zip(one, tcons.consensus_update_ref(a[0], y[0], z[0], adjm,
                                                     w, fusion)):
        assert torch.equal(g[0], wv)


@pytest.mark.parametrize("mode,fan", [
    ("dense", False), ("joseph", False), ("fft_skew", False),
    ("fft_grouped", False), ("fft_pallas", False), ("fft_shear", False),
    ("fft_mxu", False), ("dense", True), ("joseph", True),
    ("fft_skew", True), ("fft_grouped", True)])
def test_batched_operators_equal_each_lane(mode, fan):
    """A problem's forward and adjoint on B * P images (b-major) against
    each lane's P images alone, in every mode the port builds (the fft
    modes take PB images against PT table sets, image p using set p % PT;
    the hat-weight rule sizes its weights by PT, so a batch leaves it as
    it is): Joseph bit for bit, the others within 1e-6 of the max (the
    dense product of B columns, and the fft modes' einsums over B, sum in
    another order)."""
    geo = tcfg.GeometryConfig(N=N, num_nodes=P, angles_total=24,
                              fan_beam=fan, det_width_factor=2.0 if fan
                              else 1.0)
    cfg = tcfg.ProblemConfig(geometry=geo)
    tp = tloader.build_problem(cfg, "cpu", mode=mode)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((3 * P, N * N)),
                        dtype=torch.float32)
    r = torch.as_tensor(rng.standard_normal((3 * P, tp.m_flat)),
                        dtype=torch.float32)
    for op, v in ((tp.forward, x), (tp.adjoint, r)):
        got = op(v)
        for s in range(3):
            want = op(v[s * P:(s + 1) * P])
            if mode != "joseph":
                np.testing.assert_allclose(
                    got[s * P:(s + 1) * P].numpy(), want.numpy(), rtol=0,
                    atol=1e-6 * float(want.abs().max()))
            else:
                assert torch.equal(got[s * P:(s + 1) * P], want)
