"""The ctypes argument types that ``ops/kernels/_build.py`` declares for
each C entry point match the entry's parameters in ``csrc/<library>.cu``
(a pointer for each pointer, a C int for each int, in order): a mismatch
shows only when the card calls the entry, so it is checked here on the
CPU, from the sources."""

import ctypes
import re

import pytest

from dip_admm_tpu_torch.ops.kernels import _build

# A C entry: ``int dip_...(...) {`` inside an ``extern "C" {`` block, or
# declared ``extern "C" int dip_...(...) {`` on its own.
ENTRY = re.compile(r'^(?:extern "C" )?int (dip_\w+)\(([^)]*)\)\s*\{', re.M)


def _entries(name: str) -> dict:
    out = {}
    for fn, params in ENTRY.findall((_build.CSRC / f"{name}.cu").read_text()):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                kinds.append(ctypes.c_void_p)
            else:
                assert p.startswith("int "), (fn, p)
                kinds.append(ctypes.c_int)
        out[fn] = kinds
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_declared_argtypes_match_the_c_entries(name):
    assert _entries(name) == _build.SIGNATURES[name]


def test_consensus_takes_its_batch_count():
    """K5's single-device entry takes the batch count B of its [B, P, P, n]
    edge state before P; the sharded entry has no batch."""
    src = (_build.CSRC / "consensus.cu").read_text()
    params = {fn: [" ".join(p.split()).split()[-1].lstrip("*")
                   for p in ps.split(",")] for fn, ps in ENTRY.findall(src)}
    assert params["dip_consensus"][9:13] == ["B", "P", "n", "weighted"]
    assert "B" not in params["dip_consensus_sharded"]
