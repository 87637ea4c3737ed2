"""BENCHMARK.json and the files it names: found, parsed, and within the
contract's limits on names, units, bounds and paths."""

import importlib
import json

import pytest

from portbench import check, control, spec

MAN = spec.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
COUNTS = sorted(p.stem for p in (spec.HERE / "counts").glob("[!_]*.py"))


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME.match(name), name
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} == {
        "recon_it_per_s", "psnr_db", "setup_s"}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_file(name):
    entry = {c["name"]: c for c in MAN["configs"]}[name]
    conf = json.loads((spec.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/configs/")
    assert conf["name"] == name and conf["source"] == entry["source"]
    assert entry["reduced"] == []
    for key in ("geometry", "graph", "admm", "noise_level", "phantom",
                "mode", "dtype", "fft_table_dtype", "libraries"):
        assert key in conf, key


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = spec.cell(cell)
    assert c["cell"]["chips"] == 1
    assert len(c["cell"]["why"]) <= 200
    assert c["limits"]["control"] in control.CONTROLS
    assert set(c["limits"]["numbers"]) <= set(check.NUMBERS)
    for v in c["limits"]["numbers"].values():
        assert v["lower"] < v["limit"] < v["upper"]
        assert v["upper"] >= 3 * v["lower"]
    assert c["per_layer"] and c["end_to_end"]


@pytest.mark.parametrize("mix", ["fcv_single", "fcv_batch16", "cv_batch4"])
def test_mix_file(mix):
    m = json.loads((spec.HERE / "mixes" / f"{mix}.json").read_text())
    assert m["batched"] or len(m["scales"]) == 1
    assert m["recipe"]["node"]["algorithm"] in ("fcv", "cv")
    assert m["trace"]["recons"] >= 1


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_metric_reader(name):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert callable(mod.read)


@pytest.mark.parametrize("name", COUNTS)
def test_kernel_count(name):
    mod = importlib.import_module(f"portbench.counts.{name}")
    mname, fname = mod.WRAPPER.split(":")
    assert fname == name
    assert callable(getattr(importlib.import_module(mname), fname))
    assert mod.ROLE in ("projector", "consensus")
