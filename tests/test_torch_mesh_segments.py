"""Snapshots and checkpoints on a mesh: ``run_one_strategy`` with
``checkpoint_every``, ``resume`` and ``snapshot_every`` on a 2-node gloo
mesh of the CPU (``parallel.mesh.launch``, two processes), on a JAX
mode-``fft`` bundle (N = 16, 4 nodes, 4 outers).

Tolerances: a run resumed from the mesh's own checkpoint equals the
unbroken mesh run bit for bit (the rank-local segments continue one
another exactly, and a checkpoint holds the gathered state); the mesh
against the port's single-device run as in ``test_torch_sharded.py``
(state 2e-4); snapshots equal the state they were taken of bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_mesh_worker as worker
from dip_admm_tpu import config as jcfg
from dip_admm_tpu.core import admm as jadmm
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.parallel import admm_sharded
from dip_admm_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

X_RTOL, X_ATOL = 2e-4, 2e-4
TAG = "knn_k1"


def _cfg():
    return jcfg.ProblemConfig(
        geometry=jcfg.GeometryConfig(N=16, num_nodes=4, angles_total=16),
        graph=jcfg.GraphConfig(strategy="knn", k=1, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=4, eps_pri=1e-8, eps_dual=1e-8,
            node=jcfg.NodeSolverConfig(max_inner=40, check_every=20)),
        phantom="shepp",
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("segments")
    cfg = _cfg()
    pj = jloader.build_problem(cfg, mode="fft")
    bundle = str(d / "problem.npz")
    jser.save_problem(pj, bundle)
    part = jadmm.run_admm(pj, cfg.admm, until=2)
    jax_ckpt = str(d / "jax_checkpoint.npz")
    jser.save_checkpoint(jax_ckpt, part.state, part.history)
    got = tmesh.launch(worker.segments, 2, "cpu",
                       args=(bundle, str(d / "out"), jax_ckpt),
                       init_file=str(d / "rendezvous"))[0]
    return d, bundle, jax_ckpt, got


def _ckpt(d, name):
    state, hist = tser.load_checkpoint(str(d / "out" / name / TAG /
                                           "checkpoint.npz"), "cpu")
    return state, hist


def test_mesh_checkpoints_match_single_device(runs):
    """Rank 0's checkpoints (the gathered state) of the unbroken mesh run
    against the port's single-device run of the same 4 outers."""
    d, bundle, _, got = runs
    p = tser.load_problem(bundle, "cpu")
    ref = tadmm.run_admm(p, p.cfg.admm)
    state, hist = _ckpt(d, "unbroken")
    assert state.k == ref.n_iters == 4
    np.testing.assert_array_equal(got["unbroken"], state.node.x.numpy())
    for name in ("Z", "Y"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   getattr(ref.state, name).numpy(),
                                   rtol=X_RTOL, atol=X_ATOL, err_msg=name)
    np.testing.assert_allclose(state.node.x.numpy(), ref.x.numpy(),
                               rtol=X_RTOL, atol=X_ATOL)
    assert hist["primal"].shape == ref.history["primal"].shape
    assert hist["pri_per_node"].shape == (4, 4)


def test_mesh_resume_equals_unbroken_run(runs):
    d, _, _, got = runs
    part, _ = _ckpt(d, "part")
    assert part.k == 2
    a, ha = _ckpt(d, "unbroken")
    b, hb = _ckpt(d, "resumed")
    assert a.k == b.k == 4
    np.testing.assert_array_equal(got["resumed"], got["unbroken"])
    for name in ("Z", "Y"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      getattr(a, name).numpy())
    for name, v in ha.items():
        np.testing.assert_array_equal(hb[name].numpy(), v.numpy(),
                                      err_msg=name)


def test_mesh_snapshots(runs):
    """Snapshots under the JAX package's file names, every 2 outers; the
    last equals the run's final x."""
    d, _, _, got = runs
    snap = d / "out" / "snapshots" / TAG / "snapshots"
    names = {f.name for f in snap.iterdir() if f.suffix == ".npy"}
    assert names == {f"iter_{k:04d}_node_{i}.npy" for k in (2, 4)
                     for i in range(4)}
    for i in range(4):
        np.testing.assert_array_equal(
            np.load(snap / f"iter_0004_node_{i}.npy").reshape(-1),
            got["snapshots"][i])
    np.testing.assert_array_equal(got["snapshots"], got["unbroken"])


def test_jax_checkpoint_resumes_on_the_mesh(runs):
    """The JAX package's checkpoint after 2 outers, resumed on the mesh,
    against its resume on one device."""
    d, bundle, jax_ckpt, got = runs
    p = tser.load_problem(bundle, "cpu")
    state, hist = tser.load_checkpoint(jax_ckpt, "cpu")
    ref = tadmm.run_admm(p, p.cfg.admm, state=state,
                         hist=tadmm.grow_history(hist, 4))
    np.testing.assert_allclose(got["from_jax"], ref.x.numpy(), rtol=X_RTOL,
                               atol=X_ATOL)
    mesh_state, _ = _ckpt(d, "from_jax")
    for name in ("Z", "Y"):
        np.testing.assert_allclose(getattr(mesh_state, name).numpy(),
                                   getattr(ref.state, name).numpy(),
                                   rtol=X_RTOL, atol=X_ATOL, err_msg=name)


def test_take_blocks_inverts_gather():
    """``take_blocks`` cuts a whole state into the blocks ``gather_result``
    assembles, on a 2 x 2 layout (no world needed: the blocks follow the
    mesh's indices)."""
    P, n = 4, 16
    gen = torch.Generator().manual_seed(0)
    st, hist = tadmm.init_state(_FakeProblem(P, n), _admm_cfg())
    st = st._replace(Z=torch.randn((P, P, n), generator=gen),
                     Y=torch.randn((P, P, n), generator=gen))
    parts = {}
    for r in range(4):
        m = _FakeMesh(r, 2, 2)
        parts[r] = admm_sharded.take_blocks(st, hist, _FakeProblem(P, n), m)
    z = torch.cat([torch.cat([parts[2 * i + j][0].Z for j in range(2)], 2)
                   for i in range(2)], 0)
    assert torch.equal(z, st.Z)
    assert parts[3][0].node.x.shape == (2, n)
    assert parts[3][1]["pri_per_node"].shape == (3, 2)


def _admm_cfg():
    from dip_admm_tpu_torch.config import AdmmConfig

    return AdmmConfig(max_iters=3)


@dataclasses.dataclass
class _FakeMesh:
    rank: int
    n_node: int
    pixel: int

    @property
    def node_index(self):
        return self.rank // self.pixel

    @property
    def pixel_index(self):
        return self.rank % self.pixel


class _FakeProblem:
    """What ``init_state`` and ``take_blocks`` read of a problem."""

    def __init__(self, P, n):
        self.num_nodes, self.n, self.N = P, n, int(np.sqrt(n))
        self.m_flat = 8
        self.b = torch.zeros((P, 8))
        self.device = torch.device("cpu")
