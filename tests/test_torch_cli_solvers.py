"""The slowest runs of the PyTorch port's command line, on the CPU: the
inner solvers and adapt-rho flags, and ``--mesh 2 --mesh-pixel 2`` beside a
single process (moved from ``test_torch_cli.py`` as they were, so that no
one test file holds the suite's longest path)."""

import json

import numpy as np
import pytest

from test_torch_cli import _cli


@pytest.mark.parametrize("argv", [
    ["--algorithm", "pcv"],
    ["--algorithm", "ppdhg"],
    ["--algorithm", "fista"],
    ["--rho", "20", "--adapt-rho", "--rho-mu", "2"],
    ["--adapt-rho", "--rho-mode", "stall", "--rho-stall-window", "1",
     "--rho-stall-tol", "0.99", "--max-iters", "3"],
], ids=["pcv", "ppdhg", "fista", "adapt_rho", "adapt_rho_stall"])
def test_cli_solver_flags_print_summary(argv):
    """``--algorithm pcv|ppdhg|fista`` and the adapt-rho flags."""
    out = _cli("--device", "cpu", "--N", "24", "--nodes", "3",
               "--max-iters", "2", "--max-inner", "20", *argv)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)["knn"]
    assert summary["n_iters"] == (3 if "3" in argv else 2)
    for key in ("mean_psnr", "final_primal", "final_dual"):
        assert np.isfinite(summary[key])


def test_cli_mesh_matches_single_process():
    """``--mesh 2 --mesh-pixel 2`` (four gloo ranks on the CPU) prints the
    single-process run's keys and numbers: rtol 2e-3 on the residuals and
    the PSNR (the histories' tolerance of ``test_torch_sharded.py``)."""
    argv = ("--device", "cpu", "--mode", "fft_skew", "--N", "32", "--nodes",
            "4", "--max-iters", "2")
    one = _cli(*argv)
    mesh = _cli(*argv, "--mesh", "2", "--mesh-pixel", "2")
    assert one.returncode == 0, one.stderr
    assert mesh.returncode == 0, mesh.stderr
    want, got = json.loads(one.stdout)["knn"], json.loads(mesh.stdout)["knn"]
    assert set(got) == set(want)
    for key in ("tag", "n_iters", "graph"):
        assert got[key] == want[key], key
    for key in ("final_primal", "final_dual", "mean_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                   err_msg=key)
