"""``parallel/multihost.py`` of the PyTorch port on the CPU: the
single-process no-op, the host-major rank order, the placement of each
Problem field against the JAX package's ``problem_shardings`` (the shared
table leaf whose leading size is the node count included), and a world of
two processes joined by an environment rendezvous (``MASTER_ADDR`` =
127.0.0.1, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) that distributes a
mode-``fft`` problem (parallel and fan beam, N = 16, 4 nodes) and runs 3
outers: x, Z and Y against the port's single-device run as in
``test_torch_sharded.py`` (2e-4); each rank holds its blocks exactly."""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dip_admm_tpu import config as jcfg
from dip_admm_tpu.data import loader as jloader
from dip_admm_tpu.data import serialization as jser
from dip_admm_tpu.parallel import mesh as jmesh
from dip_admm_tpu.parallel import multihost as jmh
from dip_admm_tpu_torch.core import admm as tadmm
from dip_admm_tpu_torch.data import serialization as tser
from dip_admm_tpu_torch.parallel import mesh as tmesh
from dip_admm_tpu_torch.parallel import multihost

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
X_RTOL, X_ATOL = 2e-4, 2e-4
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_WORLD_SIZE", "LOCAL_RANK")


def _cfg(fan: bool):
    geo = (jcfg.GeometryConfig(N=16, num_nodes=4, angles_total=32,
                               fan_beam=True) if fan
           else jcfg.GeometryConfig(N=16, num_nodes=4, angles_total=16))
    return jcfg.ProblemConfig(
        geometry=geo,
        graph=jcfg.GraphConfig(strategy="knn", k=1, seed=123),
        admm=jcfg.AdmmConfig(
            max_iters=3, eps_pri=1e-8, eps_dual=1e-8,
            node=jcfg.NodeSolverConfig(max_inner=40, check_every=20)),
        phantom="shepp",
    )


@pytest.fixture(scope="module", params=[False, True], ids=["parallel", "fan"])
def bundle(request, tmp_path_factory):
    """A JAX mode-``fft`` problem and its bundle."""
    cfg = _cfg(request.param)
    pj = jloader.build_problem(cfg, mode="fft")
    path = str(tmp_path_factory.mktemp("multihost") / "problem.npz")
    jser.save_problem(pj, path)
    return pj, path


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_is_a_no_op_in_one_process(clean_env):
    multihost.initialize()
    assert not dist.is_initialized()


def test_initialize_needs_every_part(clean_env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize()
    assert not dist.is_initialized()


@pytest.mark.parametrize("hosts, ok", [
    (["a", "a", "b", "b"], True),
    (["a", "b", "c"], True),
    (["a", "b", "a"], False),
    (["a", "a", "b", "a"], False),
])
def test_ranks_must_be_host_major(hosts, ok):
    if ok:
        multihost.check_host_major(hosts)
    else:
        with pytest.raises(ValueError, match="consecutive"):
            multihost.check_host_major(hosts)


def test_global_mesh_in_one_process(clean_env, bundle):
    """A world of one: the mesh holds every node, and the distributed
    problem is the whole one."""
    _, path = bundle
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.n_node, mesh.pixel, mesh.rank) == (1, 1, 0)
    with pytest.raises(ValueError, match="every rank"):
        multihost.global_mesh(2, device="cpu")
    p = tser.load_problem(path, "cpu")
    dp = multihost.distribute_problem(p, mesh)
    assert dp.node_block == (0, p.num_nodes)
    assert torch.equal(dp.b, p.b) and torch.equal(dp.Q, p.Q)
    with pytest.raises(ValueError, match="already"):
        multihost.distribute_problem(dp, mesh)


def _specs_of_jax(tree):
    """JAX PartitionSpecs as the port's placements."""
    if isinstance(tree, dict):
        return {k: _specs_of_jax(v) for k, v in tree.items()}
    return tmesh.NODE_AXIS if tuple(tree) == (jmesh.NODE_AXIS,) else None


def test_problem_shardings_match_jax(bundle):
    """Every Problem field and table leaf placed as JAX places it, and a
    ``"shared"`` leaf whose leading size is the node count kept whole in
    both (the JAX package's collision case)."""
    pj, path = bundle
    fan = pj.cfg.geometry.fan_beam
    p = tser.load_problem(path, "cpu")
    P = p.num_nodes
    p.fft_tables.setdefault("shared", {})["probe"] = torch.zeros((P, 3))
    got = multihost.problem_shardings(p, None)
    tables_j = {**pj.fft_tables, "shared": {"probe": np.zeros((P, 3))}}
    want = jmh.problem_shardings(
        dataclasses.replace(pj, fft_tables=tables_j), jmesh.make_mesh(1))
    for name, spec in want.items():
        if name == "A":
            assert spec is None
            continue
        if name == "fft_tables" and fan:
            continue  # another layout, below
        assert got[name] == _specs_of_jax(spec), name
    specs = got["fft_tables"]
    assert specs["shared"]["probe"] is None
    if not fan:
        assert specs["Hre_r"] == tmesh.NODE_AXIS
        return
    # Fan mode fft: JAX splits P equal copies of one node's tables over
    # the nodes; the port keeps the one copy whole on every rank, and
    # splits the row mask as JAX does.
    want_t = _specs_of_jax(want["fft_tables"])
    assert want_t.pop("shared") == {"probe": None}
    assert set(want_t.values()) == {tmesh.NODE_AXIS}
    assert set(specs) == {"shared", "fan_valid"}
    assert set(specs["shared"]) == set(want_t) - {"fan_valid"} | {"probe"}
    assert set(specs["shared"].values()) == {None}
    assert specs["fan_valid"] == tmesh.NODE_AXIS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_env_rendezvous_run_matches_single_device(bundle, tmp_path):
    _, path = bundle
    out = str(tmp_path / "rank0.npz")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    code = ("import sys; sys.path.insert(0, sys.argv[3]); "
            "import _torch_mesh_worker as w; "
            "w.multihost_rank(sys.argv[1], sys.argv[2])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, path, out, str(ROOT / "tests")],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err
    got = np.load(out)
    assert int(got["world"]) == 2 and int(got["n_iters"]) == 3
    p = tser.load_problem(path, "cpu")
    ref = tadmm.run_admm(p, p.cfg.admm)
    for name, want in (("x", ref.x), ("Z", ref.state.Z), ("Y", ref.state.Y)):
        np.testing.assert_allclose(got[name], want.numpy(), rtol=X_RTOL,
                                   atol=X_ATOL, err_msg=name)
