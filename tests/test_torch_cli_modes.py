"""The PyTorch port's command line on each projector mode and beam, on the
CPU (moved from ``test_torch_cli.py`` as it was, so that no one test file
holds the suite's longest path)."""

import json

import numpy as np
import pytest

from test_torch_cli import _cli


@pytest.mark.parametrize("argv, nodes", [
    (["--fan-beam", "--mode", "fft_skew", "--N", "32", "--nodes", "2",
      "--angles", "64"], 2),
    (["--fan-beam", "--mode", "fft_grouped", "--N", "24", "--nodes", "2",
      "--angles", "64"], 2),
    (["--mode", "fft_grouped", "--N", "32", "--nodes", "3"], 3),
    (["--mode", "fft_pallas", "--N", "32", "--nodes", "3"], 3),
    (["--mode", "fft_shear", "--N", "32", "--nodes", "3"], 3),
    (["--mode", "fft_mxu", "--N", "32", "--nodes", "3"], 3),
    (["--mode", "joseph", "--N", "32", "--nodes", "3"], 3),
    (["--fan-beam", "--mode", "joseph", "--N", "24", "--nodes", "2",
      "--angles", "64"], 2),
    (["--fan-beam", "--N", "24", "--nodes", "2", "--angles", "64"], 2),
], ids=["fan", "fan_grouped", "grouped", "pallas", "shear", "mxu", "joseph",
        "fan_joseph", "fan_auto_dense"])
def test_cli_geometry_and_mode_print_summary(argv, nodes):
    """``--fan-beam`` and ``--mode fft_grouped``, ``fft_pallas``,
    ``fft_shear``, ``fft_mxu`` and ``joseph``, and the fan default (dense
    at N <= 128), under the recommended preset."""
    out = _cli("--device", "cpu", "--recommended", "--max-iters", "2", *argv)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)["knn"]
    assert summary["n_iters"] == 2
    assert summary["graph"]["num_nodes"] == nodes
    for key in ("mean_psnr", "final_primal", "final_dual"):
        assert np.isfinite(summary[key])
