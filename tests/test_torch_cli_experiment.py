"""The port CLI's experiment flags on the CPU (``--all-strategies``,
``--out``, ``--save-problem``/``--load-problem``, ``--checkpoint-every``/
``--resume``, ``--snapshot-every``, ``--per-node-phantoms``,
``--profile-dir``): each run exits 0 and prints the JAX CLI's summary keys
(read from a run of the JAX CLI), and what it writes is checked.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# The keys of each strategy's summary in the JAX CLI's JSON.
SUMMARY_KEYS = {"tag", "n_iters", "final_primal", "final_dual", "mean_psnr",
                "graph", "out_dir"}


# Each run starts in a fresh temporary directory.
SMALL = ("--device", "cpu", "--N", "16", "--nodes", "3", "--max-iters", "2")


def _cli(*args, timeout=300):
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        return subprocess.run(
            [sys.executable, "-m", "dip_admm_tpu_torch.runners.cli", *args],
            cwd=tmp, capture_output=True, text=True, timeout=timeout,
            env={**os.environ, "OMP_NUM_THREADS": "2",
                 "PYTHONPATH": str(ROOT)})


@pytest.fixture(scope="module")
def jax_summary(tmp_path_factory):
    """The JAX CLI's summary of one small run (its keys are the contract)."""
    out = subprocess.run(
        [sys.executable, "-m", "dip_admm_tpu.runners.cli", "--N", "16",
         "--nodes", "3", "--max-iters", "1", "--out",
         str(tmp_path_factory.mktemp("jax_cli"))],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)["knn"]
    assert set(summary) == SUMMARY_KEYS
    return summary


def _ok(out) -> dict:
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_cli_all_strategies_writes_artifacts(tmp_path, jax_summary):
    res = _ok(_cli(*SMALL, "--all-strategies", "--out", str(tmp_path)))
    assert list(res) == ["mst", "chain", "knn"]
    for strategy, summary in res.items():
        assert set(summary) == set(jax_summary), strategy
        assert set(summary["graph"]) == set(jax_summary["graph"])
        out_dir = Path(summary["out_dir"])
        assert out_dir == tmp_path / summary["tag"]
        assert (out_dir / "run_parameters.txt").exists()
        assert (out_dir / f"{summary['tag']}_node_2.npy").exists()
    assert res["mst"]["graph"]["num_edges"] <= 3
    assert res["mst"]["mean_psnr"] != res["knn"]["mean_psnr"]


def test_cli_save_then_load_problem(tmp_path, jax_summary):
    """``--save-problem`` writes a bundle; ``--load-problem`` of it gives
    the same run, and with another ``--strategy`` rebuilds only the graph."""
    bundle = str(tmp_path / "p.npz")
    saved = _ok(_cli(*SMALL, "--save-problem", bundle, "--out",
                     str(tmp_path / "a")))["knn"]
    loaded = _ok(_cli(*SMALL, "--load-problem", bundle, "--out",
                      str(tmp_path / "a")))["knn"]
    assert loaded == saved
    mst = _ok(_cli(*SMALL, "--load-problem", bundle, "--strategy", "mst",
                   "--out", str(tmp_path / "b")))["mst"]
    assert set(mst) == set(jax_summary)
    assert mst["tag"] == "mst" and mst["graph"] != saved["graph"]


def test_cli_checkpoint_then_resume(tmp_path):
    """Two outers in one-outer segments, then a resume to four: the
    four-outer run's numbers."""
    _ok(_cli(*SMALL, "--checkpoint-every", "1", "--out", str(tmp_path / "a")))
    ckpt = tmp_path / "a" / "knn_k2" / "checkpoint.npz"
    assert ckpt.exists()
    four = [a if a != "2" else "4" for a in SMALL]
    resumed = _ok(_cli(*four, "--checkpoint-every", "2", "--resume",
                       str(ckpt), "--out", str(tmp_path / "b")))["knn"]
    whole = _ok(_cli(*four, "--out", str(tmp_path / "b")))["knn"]
    assert resumed["n_iters"] == 4
    assert resumed == whole


def test_cli_snapshots_per_node_phantoms_and_profile(tmp_path, jax_summary):
    prof = tmp_path / "prof"
    res = _ok(_cli(*SMALL, "--per-node-phantoms", "--snapshot-every", "1",
                   "--profile-dir", str(prof), "--out", str(tmp_path)))
    summary = res["knn"]
    assert set(summary) == set(jax_summary)
    snaps = {p.name for p in (tmp_path / "knn_k2" / "snapshots").iterdir()}
    assert snaps == {f"iter_{k:04d}_node_{i}.{ext}" for k in (1, 2)
                     for i in range(3) for ext in ("npy", "png")}
    assert (prof / "trace.json").stat().st_size > 0


def test_cli_all_strategies_on_a_mesh(tmp_path):
    """``--all-strategies --mesh 2`` (two gloo ranks, each rebuilding the
    graph for every strategy; rank 0 writes the artifacts) prints the
    single-process run's numbers: rtol 2e-3, as ``test_torch_cli.py``'s
    mesh check."""
    argv = ("--device", "cpu", "--N", "16", "--nodes", "4", "--max-iters",
            "1", "--all-strategies")
    one = _ok(_cli(*argv, "--out", str(tmp_path / "one")))
    mesh = _ok(_cli(*argv, "--mesh", "2", "--out", str(tmp_path / "mesh")))
    assert list(mesh) == list(one) == ["mst", "chain", "knn"]
    for strategy, want in one.items():
        got = mesh[strategy]
        assert (got["tag"], got["n_iters"], got["graph"]) == (
            want["tag"], want["n_iters"], want["graph"])
        for key in ("final_primal", "final_dual", "mean_psnr"):
            assert abs(got[key] - want[key]) <= 2e-3 * abs(want[key]), key
        assert (Path(got["out_dir"]) / "run_parameters.txt").exists()
