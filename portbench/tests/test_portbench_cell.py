"""The harness end to end on a tiny CPU cell: one contract line, the
reference's agreement with the program, the control and the faults
caught, and no JAX in the process that prints the result."""

import importlib.util
import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec

TINY = str(spec.HERE / "tests" / "tiny.py")
_t = importlib.util.spec_from_file_location("tiny", TINY)
tiny = importlib.util.module_from_spec(_t)
_t.loader.exec_module(tiny)
CELLS = [("par512_p8", "fcv_single"), ("par256_p8", "fcv_batch16")]


def _tiny(*args):
    proc = subprocess.run([sys.executable, TINY, *args], capture_output=True,
                          text=True, timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), proc.stderr


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "par256_p8."
         "fcv_batch16", "--seed", "1", "--seconds", "1", "--trace", "0",
         *extra], capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    proc = _run(spec.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench")
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("config,mix", CELLS)
def test_tiny_cell_line(config, mix):
    out, err = _tiny(config, mix)
    assert out["correct"] is True
    assert out["forbidden"] == []
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert set(out["metrics"]) == {"recon_it_per_s", "psnr_db", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-2:] == ["checked", "forbidden"]
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("config,mix", CELLS)
def test_tiny_cell_traced(config, mix):
    out, _ = _tiny(config, mix, "--trace")
    assert out["correct"] is True
    assert out["forbidden"] == []


@pytest.mark.parametrize("config,mix", CELLS)
def test_control_fails_where_program_passes(config, mix):
    lim = tiny.LIMITS[config]
    out, _ = _tiny(config, mix, "--control", lim["control"], "--seeds",
                   "3,4,5")
    nums = lim["numbers"]
    assert all(out["lower"][k] <= v["limit"] for k, v in nums.items())
    assert any(out["upper"][k] > v["limit"] for k, v in nums.items())


@pytest.mark.parametrize("config,mix,fault", [
    (c, m, f) for c, m in CELLS
    for f in ("unchanged_step", "no_exchange", "altered_answer")
] + [("par256_p8", "fcv_batch16", "half_batch")])
def test_fault_is_caught(config, mix, fault):
    out, _ = _tiny(config, mix, "--fault", fault)
    assert out["correct"] is False


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_tiny_fan_cell(fault):
    """``par256_p8`` at N = 32 in a fan beam (``tiny.FAN``: width 2.1, 8
    nodes of 12 source angles) through ``run.run_cell``, held to the fan
    reference: correct, and not with the exchange between nodes left
    out."""
    extra = ["--fault", fault] if fault else []
    out, _ = _tiny("par256_p8", "fcv_batch16", "--fan", *extra)
    assert out["correct"] is (fault is None)
    assert out["forbidden"] == []


def test_fan_control_fails_where_program_passes():
    lim = tiny.LIMITS["par256_p8.fan"]
    out, _ = _tiny("par256_p8", "fcv_batch16", "--fan", "--control",
                   lim["control"], "--seeds", "3,4,5")
    nums = lim["numbers"]
    assert all(out["lower"][k] <= v["limit"] for k, v in nums.items())
    assert any(out["upper"][k] > v["limit"] for k, v in nums.items())


def test_forbidden_by_whole_top_level_name(monkeypatch):
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "dip_admm_tpu_torch.fake",
                        types.ModuleType("dip_admm_tpu_torch.fake"))
    assert "dip_admm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dip_admm_tpu.fake",
                        types.ModuleType("dip_admm_tpu.fake"))
    assert "dip_admm_tpu" in run.forbidden_modules()
