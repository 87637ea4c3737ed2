"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<mix>`` is one entry of ``workloads``; its configuration
is ``configs/<config>.json``, its mix ``mixes/<mix>.json`` and its
correctness limits ``limits/<cell>.json``. A per-layer metric ``<name>``
is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's entry, its configuration, mix and limits, and the
    metrics it reports: {"cell", "config", "mix", "limits", "end_to_end",
    "per_layer"}."""
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(one of {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": w,
        "config": _json(ROOT / conf["file"]),
        "mix": _json(HERE / "mixes" / f"{w['traffic']}.json"),
        "limits": _json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in man["end_to_end"] if applies(m)],
        "per_layer": [m for m in man["per_layer"] if applies(m)],
    }
