"""The readers of the fan rebin and the edge state (``rebin_ms_per_outer``,
``rebin_launches_per_outer``, ``edge_ms_per_outer``) on a synthetic join
whose answers are known: one reconstruction of one outer on a fan
projector, each call's ``proj.rebin`` nested in its ``proj.fwd`` or
``proj.adj``, times in ns."""

import importlib
import types

import pytest

from portbench import spans
from dip_admm_tpu_torch.utils.profiling import Span

READERS = ("rebin_ms_per_outer", "rebin_launches_per_outer",
           "edge_ms_per_outer")
# The fan spans, which a parallel-beam cell or an older program lacks.
NEW = ("proj.rebin", "admm.neighbours")


def _spans(shift=0, drop=()):
    rows = [  # id, parent, name, t0, t1
        (1, None, "admm.run", 0, 1000),
        (2, 1, "admm.fcv_build", 10, 100),
        (3, 2, "proj.fwd", 20, 40),
        (4, 3, "proj.rebin", 30, 40),
        (5, 2, "sync", 80, 95),
        (6, 1, "admm.outer", 100, 600),
        (7, 6, "admm.neighbours", 100, 110),
        (8, 6, "node.solve", 110, 400),
        (9, 8, "proj.fwd", 120, 150),
        (10, 9, "proj.rebin", 140, 150),
        (11, 8, "proj.adj", 160, 200),
        (12, 11, "proj.rebin", 160, 170),
        (13, 8, "sync", 300, 350),
        (14, 6, "admm.consensus", 400, 450),
        (15, 6, "admm.history", 450, 500),
        (16, 15, "proj.fwd", 455, 470),
        (17, 16, "proj.rebin", 465, 470),
        (18, 6, "sync", 550, 590),
    ]
    return [Span(i, p, 1, n, a + shift, b + shift, {})
            for i, p, n, a, b in rows if n not in drop]


# Host runtime calls (start, end, name, correlation id) and the device's
# records (start, end, name, correlation ids).
HOST = [(25, 27, "cudaLaunchKernel", 1), (32, 33, "cudaLaunchKernel", 2),
        (85, 86, "cudaMemcpyAsync", 3), (104, 105, "cudaLaunchKernel", 4),
        (125, 127, "cudaLaunchKernel", 5), (142, 143, "cudaLaunchKernel", 6),
        (145, 146, "cudaLaunchKernel", 7), (162, 163, "cudaLaunchKernel", 8),
        (175, 176, "cudaLaunchKernel", 9), (305, 306, "cudaMemcpyAsync", 10),
        (410, 412, "cudaLaunchKernel", 11),
        (460, 462, "cudaLaunchKernel", 12),
        (466, 467, "cudaLaunchKernel", 13),
        (560, 561, "cudaMemcpyAsync", 14)]
DEVICE = [(30, 60, "skew_fwd", (1,)), (61, 70, "rebin_fcv", (2,)),
          (90, 91, "Memcpy DtoH", (3,)), (106, 126, "neighbours", (4,)),
          (130, 170, "skew_fwd", (5,)), (171, 175, "rebin_dft", (6,)),
          (176, 181, "rebin_idft", (7,)), (182, 190, "rebin_t", (8,)),
          (191, 231, "skew_t", (9,)), (310, 312, "Memcpy DtoH", (10,)),
          (415, 430, "K5", (11,)), (470, 480, "skew_fwd", (12,)),
          (481, 484, "rebin_hist", (13,)), (565, 566, "Memcpy DtoH", (14,))]
UNTRACED_S = 1e-6

# Inside admm.outer: the rebin's records 4 + 5 + 8 + 3 ns (the fcv
# build's 9 left out) from four launches; the neighbour terms' 20 ns and
# K5's 15.
KNOWN = {"rebin_ms_per_outer": 20e-6, "rebin_launches_per_outer": 4.0,
         "edge_ms_per_outer": 35e-6}


def _joined(shift=0, device=DEVICE, drop=()):
    rec = spans.Records(device, HOST, 0, 1000)
    return spans.Joined(rec, _spans(shift, drop), {"sync": 3}, 1, UNTRACED_S)


def _ctx(j):
    return types.SimpleNamespace(_spans_joined=j)


def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", READERS)
def test_known_answers(name):
    j = _joined()
    assert j.trusted()
    assert _reader(name).read(_ctx(j)) == pytest.approx(KNOWN[name])


def test_rebin_nests_in_the_projector_spans():
    j = _joined()
    paths = j.device_by_span(j.path)
    assert paths["admm.run/admm.outer/node.solve/proj.adj/proj.rebin"] \
        == pytest.approx(8e-9)
    assert j.launches_by_span()["proj.rebin"] == 5  # the fcv build's too


@pytest.mark.parametrize("name", ["proj_ms_per_outer", "fcv_build_ms",
                                  "solve_idle_pct", "sync_idle_pct"])
def test_existing_readers_keep_their_value(name):
    # The new spans nest inside spans the readers already read: the same
    # window without them reads the same.
    with_new = _reader(name).read(_ctx(_joined()))
    without = _reader(name).read(_ctx(_joined(drop=NEW)))
    assert with_new == pytest.approx(without)
    if name == "proj_ms_per_outer":  # 40 + 4 + 5 + 8 + 40 + 10 + 3
        assert with_new == pytest.approx(110e-6)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_new_spans(name):
    assert _reader(name).read(_ctx(_joined(drop=NEW))) is None


def test_edge_needs_the_neighbour_span():
    j = _joined(drop=("admm.neighbours",))
    assert _reader("edge_ms_per_outer").read(_ctx(j)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_misaligned_clocks(name):
    j = _joined(shift=10**6)
    assert j.alignment() == 0.0
    assert _reader(name).read(_ctx(j)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_incomplete_trace(name):
    j = _joined(device=DEVICE[:-2])  # the history's rebin lost its record
    assert not j.records.complete()
    assert _reader(name).read(_ctx(j)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace(name):
    import torch

    ctx = types.SimpleNamespace(trace=None, device=torch.device("cpu"))
    assert _reader(name).read(ctx) is None
