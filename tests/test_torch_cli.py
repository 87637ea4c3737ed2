"""The PyTorch port's command line, on the CPU.

Each run starts in a fresh temporary directory, where the CLI writes its
artifacts (``Recon_Out_ADMM_<date>_<time>`` unless ``--out`` is given).
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _cli(*args, timeout=300):
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        return subprocess.run(
            [sys.executable, "-m", "dip_admm_tpu_torch.runners.cli", *args],
            cwd=tmp, capture_output=True, text=True, timeout=timeout,
            env={**os.environ, "OMP_NUM_THREADS": "2",
                 "PYTHONPATH": str(ROOT)},
        )


def test_cli_prints_summary():
    out = _cli("--device", "cpu", "--mode", "fft_skew", "--N", "32",
               "--nodes", "3", "--max-iters", "2")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)["knn"]
    assert summary["n_iters"] == 2
    for key in ("mean_psnr", "final_primal", "final_dual"):
        assert isinstance(summary[key], float)
    assert summary["graph"]["num_nodes"] == 3
    assert summary["graph"]["connected"] is True


def test_cli_recommended_prints_summary():
    out = _cli("--recommended", "--device", "cpu", "--mode", "fft_skew",
               "--N", "32", "--nodes", "8", "--max-iters", "2")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)["knn"]
    assert summary["n_iters"] == 2
    assert summary["graph"]["num_nodes"] == 8
    for key in ("mean_psnr", "final_primal", "final_dual"):
        assert isinstance(summary[key], float)


@pytest.mark.parametrize("argv, want", [
    ([], dict(algorithm="cv", relax_alpha=1.0, max_inner=200,
              check_every=10)),
    (["--recommended"], dict(algorithm="fcv", relax_alpha=1.8, max_inner=15,
                             check_every=15)),
    (["--recommended", "--max-inner", "5", "--relax-alpha", "1.5"],
     dict(algorithm="fcv", relax_alpha=1.5, max_inner=5, check_every=15)),
])
def test_cli_preset_resolution(argv, want):
    """``--recommended`` fills what is unset; explicit flags win."""
    from dip_admm_tpu_torch.runners import cli

    args = cli.build_parser().parse_args(["--device", "cpu", *argv])
    cli.resolve_preset(args)
    node = cli.config_from_args(args).admm.node
    assert {k: getattr(args, k) for k in want} == want
    assert (node.algorithm, node.max_inner, node.check_every) == (
        want["algorithm"], want["max_inner"], want["check_every"])


def test_cli_adapt_rho_flags_reach_the_config():
    from dip_admm_tpu_torch.runners import cli

    args = cli.build_parser().parse_args([
        "--device", "cpu", "--adapt-rho", "--rho-mu", "2", "--rho-tau",
        "3", "--rho-mode", "stall", "--rho-stall-window", "5",
        "--rho-stall-tol", "0.1", "--algorithm", "fista"])
    cli.resolve_preset(args)
    a = cli.config_from_args(args).admm
    assert (a.adapt_rho, a.rho_mu, a.rho_tau, a.adapt_rho_mode,
            a.rho_stall_window, a.rho_stall_tol, a.node.algorithm) == (
        True, 2.0, 3.0, "stall", 5, 0.1, "fista")


def _summary(*args):
    out = _cli("--device", "cpu", "--N", "32", "--nodes", "3",
               "--max-iters", "2", *args)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)["knn"]


def test_cli_auto_mode_is_dense_at_n_le_128():
    """``--mode auto`` (the default) at N = 32 runs the dense operator,
    as the JAX CLI does: the same numbers as ``--mode dense``, not
    ``--mode fft_skew``'s."""
    auto, dense, skew = (_summary(), _summary("--mode", "dense"),
                         _summary("--mode", "fft_skew"))
    for s in (auto, dense):  # the artifact directory names the run's time
        assert s.pop("out_dir").endswith("knn_k2")
    assert auto == dense
    assert auto["mean_psnr"] != skew["mean_psnr"]


@pytest.mark.parametrize("args", [
    ("--N", "32"),  # no --device
    ("--device", "cpu", "--z-fusion", "mean"),
])
def test_cli_rejects_unported_flags(args):
    out = _cli(*args)
    assert out.returncode != 0
    assert "error" in out.stderr


@pytest.mark.parametrize("args", [
    ("--mesh-pixel", "2"),  # without --mesh
    ("--mesh", "0"),
])
def test_cli_rejects_a_bad_mesh(args):
    out = _cli("--device", "cpu", "--N", "32", "--nodes", "4", *args)
    assert out.returncode != 0
    assert "--mesh" in out.stderr
    assert out.stdout == ""


def test_cli_rejects_fan_beam_fft_pallas():
    out = _cli("--device", "cpu", "--fan-beam", "--mode", "fft_pallas",
               "--N", "24", "--nodes", "2", "--angles", "64",
               "--max-iters", "1")
    assert out.returncode != 0
    assert "parallel beam only" in out.stderr
    assert out.stdout == ""


def test_cli_cuda_without_a_card_fails():
    code = ("import torch, sys; sys.exit(0 if torch.cuda.is_available() "
            "else 1)")
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("this host has a CUDA device")
    out = _cli("--device", "cuda", "--N", "32", "--nodes", "3",
               "--max-iters", "2")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_smoke_busy_time_is_the_union_of_intervals():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    assert chip_smoke._busy_us([(5, 7), (0, 2), (1, 3), (6, 6.5)]) == 5.0
    assert chip_smoke._busy_us([]) == 0.0


def test_smoke_without_a_card_fails():
    code = ("import torch, sys; sys.exit(0 if torch.cuda.is_available() "
            "else 1)")
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


# ---------------------------------------------------------------------------
# The experiment flags (their runs are in test_torch_experiment.py).

SMALL = ("--device", "cpu", "--N", "16", "--nodes", "3", "--max-iters", "2")


@pytest.mark.parametrize("args", [
    ("--all-strategies", "--checkpoint-every", "1"),
    ("--checkpoint-every", "0"),
    ("--resume", "ckpt.npz"),
    ("--checkpoint-every", "1", "--snapshot-every", "1"),
], ids=["all_checkpoint", "zero", "resume_alone", "both"])
def test_cli_rejects_segment_flags(args):
    out = _cli(*SMALL, *args)
    assert out.returncode != 0
    assert "error" in out.stderr and "--" in out.stderr
    assert out.stdout == ""
