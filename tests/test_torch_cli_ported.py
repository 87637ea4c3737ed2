"""The PyTorch port's command line on the flags of its last slice, on the
CPU: ``--matrix-free`` and ``--mode fft`` (parallel and fan beam),
``--dtype``, and ``--mesh 2`` with ``--checkpoint-every`` and
``--snapshot-every`` (two gloo ranks; rank 0 writes the files)."""

import json

import numpy as np
import pytest

from test_torch_cli import _cli

SMALL = ("--device", "cpu", "--N", "16", "--nodes", "4", "--max-iters", "2")


def _summary(*args, out=None):
    res = _cli(*args, *(("--out", str(out)) if out else ()))
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout)
    return summary[next(iter(summary))]


def test_cli_matrix_free_is_mode_fft():
    """``--matrix-free`` runs mode fft: the numbers of ``--mode fft``,
    not those of the auto rule's dense."""
    mf = _summary(*SMALL, "--matrix-free")
    fft = _summary(*SMALL, "--mode", "fft")
    dense = _summary(*SMALL)
    for key in ("n_iters", "final_primal", "final_dual", "mean_psnr"):
        assert mf[key] == fft[key], key
    assert mf["mean_psnr"] != dense["mean_psnr"]
    assert np.isfinite(mf["mean_psnr"])


def test_cli_fan_beam_mode_fft():
    s = _summary("--device", "cpu", "--fan-beam", "--mode", "fft", "--N",
                 "24", "--nodes", "2", "--angles", "64", "--max-iters", "2")
    assert s["n_iters"] == 2 and np.isfinite(s["mean_psnr"])


def test_cli_dtype():
    """``--dtype float64`` runs in float32 (the numbers of the default);
    ``bfloat16`` runs on fft_skew; mode fft refuses it with the JAX
    package's error."""
    f32 = _summary(*SMALL, "--mode", "fft_skew")
    f64 = _summary(*SMALL, "--mode", "fft_skew", "--dtype", "float64")
    for key in ("n_iters", "final_primal", "final_dual", "mean_psnr"):
        assert f64[key] == f32[key], key
    bf16 = _summary(*SMALL, "--mode", "fft_skew", "--dtype", "bfloat16")
    assert bf16["n_iters"] == 2 and np.isfinite(bf16["mean_psnr"])
    res = _cli(*SMALL, "--matrix-free", "--dtype", "bfloat16")
    assert res.returncode != 0
    assert "RFFT input must be float32 or float64" in res.stderr


@pytest.mark.parametrize("flag, files", [
    ("--checkpoint-every", {"checkpoint.npz"}),
    ("--snapshot-every", {f"snapshots/iter_{k:04d}_node_{i}.npy"
                          for k in (1, 2) for i in range(4)}),
], ids=["checkpoint", "snapshot"])
def test_cli_mesh_segments(flag, files, tmp_path):
    """``--mesh 2`` with a segmented driver: the single process's numbers
    (``test_torch_cli_solvers.py``'s tolerance) and rank 0's files."""
    argv = (*SMALL, "--mode", "fft", flag, "1")
    one = _summary(*argv, out=tmp_path / "one")
    mesh = _summary(*argv, "--mesh", "2", out=tmp_path / "mesh")
    for key in ("final_primal", "final_dual", "mean_psnr"):
        np.testing.assert_allclose(mesh[key], one[key], rtol=2e-3,
                                   err_msg=key)
    run = tmp_path / "mesh" / "knn_k2"
    for f in files:
        assert (run / f).exists(), f
