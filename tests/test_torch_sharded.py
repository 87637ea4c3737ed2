"""The port's consensus loop on a node x pixel mesh
(``dip_admm_tpu_torch/parallel/admm_sharded.py``) against the JAX
package's ``run_admm_sharded`` on its virtual 8-device CPU mesh.

The port runs in gloo worlds of at most four CPU processes, one torch
thread each, started by ``parallel.mesh.launch`` with a rendezvous file in
``tmp_path`` (so xdist workers never share one); the ranks import only the
port (``tests/_torch_mesh_worker.py``). Both packages run the same JAX-built
problem: a ``save_problem`` bundle on the parallel path, and on the fan path
(whose bundles the port does not load) JAX's data with the port's own
tables. Both build their tables with ``row_block=8``, so N = 16 has NB = 2
row blocks and a 2-wide pixel axis takes the row-sharded projector. fcv
gets JAX's Lanczos start.

Tolerances, JAX's own for its sharded-vs-single-device tests
(``tests/test_sharding.py``): x within rtol 2e-4 / atol 2e-4, the histories
within rtol 2e-3 / atol 1e-5. The port's sharded run against its own
single-device run is held to the same; a run stopped after two outers and
resumed equals the straight run bit for bit. Each pixel-compute case
asserts that the row-sharded pair ran.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as worker
from dip_admm_tpu import config as jcfg
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.parallel import admm_sharded as jsharded
from dip_admm_tpu.parallel import mesh as jmesh
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

X_RTOL, X_ATOL = 2e-4, 2e-4
H_RTOL, H_ATOL = 2e-3, 1e-5
ROW_BLOCK = 8


def _cfg_jax(fan: bool):
    geo = (jcfg.GeometryConfig(N=16, num_nodes=4, angles_total=32,
                               fan_beam=True, det_width_factor=2.0,
                               src_radius=4.0, det_radius=4.0) if fan
           else jcfg.GeometryConfig(N=16, num_nodes=4, angles_total=16))
    return jcfg.ProblemConfig(
        geometry=geo,
        graph=jcfg.GraphConfig(strategy="knn", k=1, seed=123),
        admm=jcfg.AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=4, eps_pri=1e-8, eps_dual=1e-8,
            node=jcfg.NodeSolverConfig(max_inner=40, check_every=20),
        ),
        noise_level=0.002 if fan else 0.005, phantom="const",
    )


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """JAX's fft_skew problems (parallel and fan) and each one's spec for
    the port's ranks."""
    out = {}
    for fan in (False, True):
        cfg = _cfg_jax(fan)
        pj = jloader.build_problem(cfg, mode="fft_skew", row_block=ROW_BLOCK)
        d = tmp_path_factory.mktemp("fan" if fan else "parallel")
        if fan:
            np.savez(d / "data.npz", **{
                k: np.asarray(getattr(pj, k))
                for k in ("b", "W", "Q", "keep", "adj", "x_true", "opnorm")})
            spec = {"cfg": json.dumps(dataclasses.asdict(cfg)),
                    "data": str(d / "data.npz"), "mode": "fft_skew",
                    "row_block": ROW_BLOCK}
        else:
            jser.save_problem(pj, str(d / "problem.npz"))
            spec = {"bundle": str(d / "problem.npz")}
        out[fan] = (cfg, pj, spec)
    return out


def _lanczos_v0(n):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                      jnp.float32))


def _port(tmp_path, spec, n_node, pixel, changes=None, split=None, n=256):
    return tmesh.launch(
        worker.admm_run, n_node * pixel, "cpu",
        args=(spec, n_node, pixel, changes or {}, _lanczos_v0(n), split),
        init_file=str(tmp_path / "rendezvous"))[0]


def _assert_close(got: dict, x, hist):
    np.testing.assert_allclose(got["x"], np.asarray(x), rtol=X_RTOL,
                               atol=X_ATOL)
    assert set(got["history"]) == set(hist)
    for name, v in hist.items():
        np.testing.assert_allclose(got["history"][name], np.asarray(v),
                                   rtol=H_RTOL, atol=H_ATOL, err_msg=name)


CASES = {
    # name: (fan, n_node, pixel, admm changes)
    "node2_cv": (False, 2, 1, {}),
    "pixel2x2_cv": (False, 2, 2, {}),
    # A 20-step budget: at 40 one node's stationarity residual falls to
    # ~1.4e-4 of its peers' 0.46, where cancellation (in another FFT
    # library) moves it by ~6%, though x agrees.
    "pixel2x2_fcv": (False, 2, 2, {"max_iters": 3, "node": {
        "algorithm": "fcv", "max_inner": 20}}),
    "fan_pixel2x2_cv": (True, 2, 2, {}),
    # In place of JAX's 4 x 2 mesh (eight ranks): weighted fusion and
    # over-relaxation through the fused consensus kernel's sharded form.
    "pixel2x2_weighted_relax": (False, 2, 2, {
        "z_fusion": "weighted", "relax_alpha": 1.8, "use_pallas": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_sharded(problems, tmp_path, case):
    fan, n_node, pixel, changes = CASES[case]
    cfg, pj, spec = problems[fan]
    res_j = jsharded.run_admm_sharded(
        pj, worker.over(cfg.admm, changes),
        mesh=jmesh.make_mesh(n_node, pixel=pixel))
    got = _port(tmp_path, spec, n_node, pixel, changes)
    assert got["pixel_compute"] == (pixel > 1)
    if pixel > 1:
        assert got["calls"].get("project_nodes_skew_rowshard", 0) > 0
        assert got["calls"].get("backproject_nodes_skew_rowshard", 0) > 0
    else:
        assert not got["calls"]
    assert got["full"]["n_iters"] == int(res_j.n_iters)
    _assert_close(got["full"], res_j.x, res_j.history)


@pytest.mark.parametrize("changes", [
    {},
    # The recommended preset: fcv, whose preconditioner each rank builds
    # for its node block, relax 1.8.
    {"relax_alpha": 1.8, "node": {"algorithm": "fcv", "max_inner": 15,
                                  "check_every": 15}},
], ids=["cv", "recommended"])
def test_sharded_matches_port_single_device(problems, tmp_path, changes):
    """2 x 2 against the port's own ``run_admm`` on the bundle, state
    included (JAX's ``test_sharded_matches_single_device``)."""
    _, _, spec = problems[False]
    p = tser.load_problem(spec["bundle"], "cpu")
    ref = tadmm.run_admm(p, worker.over(p.cfg.admm, changes),
                         lanczos_v0=torch.as_tensor(_lanczos_v0(p.n)))
    got = _port(tmp_path, spec, 2, 2, changes)["full"]
    assert got["n_iters"] == ref.n_iters
    _assert_close(got, ref.x.numpy(),
                  {k: v.numpy() for k, v in ref.history.items()})
    for name in ("Z", "Y"):
        np.testing.assert_allclose(got[name],
                                   getattr(ref.state, name).numpy(),
                                   rtol=X_RTOL, atol=X_ATOL, err_msg=name)


def test_sharded_exact_resume(problems, tmp_path):
    """On the 2 x 2 mesh, two outers and then the rest equal one straight
    run bit for bit (the rank-local state/hist/until contract)."""
    _, _, spec = problems[False]
    got = _port(tmp_path, spec, 2, 2, split=2)
    assert got["part_iters"] == 2
    full, resumed = got["full"], got["resumed"]
    assert resumed["n_iters"] == full["n_iters"] == 4
    for name in ("x", "Z", "Y"):
        np.testing.assert_array_equal(resumed[name], full[name])
    for name, v in full["history"].items():
        np.testing.assert_array_equal(resumed["history"][name], v,
                                      err_msg=name)
