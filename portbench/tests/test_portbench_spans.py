"""The join of the program's spans with a device trace
(``portbench.spans``) and its five readers, on a synthetic window whose
answers are known: one reconstruction of one outer, times in ns."""

import importlib
import types

import pytest

from portbench import spans
from dip_admm_tpu_torch.utils.profiling import Span

READERS = ("syncs_per_outer", "sync_idle_pct", "solve_idle_pct",
           "fcv_build_ms", "proj_ms_per_outer")
JOINERS = READERS[1:]


def _spans(shift=0):
    rows = [  # id, parent, name, t0, t1
        (1, None, "admm.run", 0, 1000),
        (2, 1, "admm.fcv_build", 10, 100),
        (3, 2, "proj.fwd", 20, 40),
        (4, 2, "sync", 80, 95),
        (5, 1, "admm.outer", 100, 600),
        (6, 5, "node.solve", 110, 400),
        (7, 6, "proj.fwd", 120, 150),
        (8, 6, "proj.adj", 160, 200),
        (9, 6, "sync", 300, 350),
        (10, 5, "admm.consensus", 400, 450),
        (11, 5, "admm.history", 450, 500),
        (12, 11, "proj.fwd", 455, 470),
        (13, 5, "sync", 550, 590),
    ]
    return [Span(i, p, 1, n, a + shift, b + shift, {}) for i, p, n, a, b in
            rows]


# Host runtime calls (start, end, name, correlation id) and the device's
# records (start, end, name, correlation ids).
HOST = [(25, 27, "cudaLaunchKernel", 1), (85, 86, "cudaMemcpyAsync", 2),
        (125, 127, "cudaLaunchKernel", 3), (165, 167, "cudaLaunchKernel", 4),
        (305, 306, "cudaMemcpyAsync", 5), (410, 412, "cudaLaunchKernel", 6),
        (460, 462, "cudaLaunchKernel", 7), (560, 561, "cudaMemcpyAsync", 8)]
DEVICE = [(30, 130, "psf_kernel", (1,)), (131, 132, "Memcpy DtoH", (2,)),
          (140, 200, "fwd_kernel", (3,)), (210, 260, "adj_kernel", (4,)),
          (310, 312, "Memcpy DtoH", (5,)), (415, 430, "K5", (6,)),
          (470, 480, "fwd_kernel", (7,)), (565, 566, "Memcpy DtoH", (8,))]
UNTRACED_S = 1e-6  # 1000 ns


def _joined(shift=0, device=DEVICE):
    rec = spans.Records(device, HOST, 0, 1000)
    return spans.Joined(rec, _spans(shift), {"sync": 3, "proj.fwd": 3}, 1,
                        UNTRACED_S)


def _ctx(j):
    return types.SimpleNamespace(_spans_joined=j)


def test_attributions_add_up():
    j = _joined()
    idle = j.idle_by_span()
    assert idle == pytest.approx({
        "admm.run": 30e-9, "proj.fwd": 9e-9, "node.solve": 60e-9,
        "sync": 537e-9, "admm.consensus": 40e-9, "admm.history": 85e-9})
    busy = 1e-9 * sum(b - a for a, b in j.records.busy())
    assert busy == pytest.approx(239e-9)
    assert sum(idle.values()) + busy == pytest.approx(1000e-9)
    dev = j.device_by_span()
    assert dev == pytest.approx({"proj.fwd": 170e-9, "proj.adj": 50e-9,
                                 "sync": 4e-9, "admm.consensus": 15e-9})
    assert sum(dev.values()) == pytest.approx(busy)
    assert j.launches_by_span() == {"proj.fwd": 3, "proj.adj": 1,
                                    "admm.consensus": 1}
    assert sum(j.launches_by_span().values()) == len(j.records.launches)
    assert j.device_by_span(j.path)[
        "admm.run/admm.outer/admm.history/proj.fwd"] == pytest.approx(10e-9)


def test_metrics_known_answers():
    j = _joined()
    assert j.alignment() == 1.0 and j.trusted()
    assert j.syncs_per_outer() == 3.0
    assert j.sync_idle_pct() == pytest.approx(53.7)
    assert j.solve_idle_pct() == pytest.approx(6.9)
    # The build's span ends at 100, the last record launched in it at 132.
    assert j.fcv_build_ms() == pytest.approx(122e-6)
    # fwd 60 + adj 50 + the history's fwd 10; the build's PSF left out.
    assert j.proj_ms_per_outer() == pytest.approx(120e-6)
    notes = j.notes()
    assert notes["outer_ms"] == pytest.approx([500e-6])
    # The idle adds up to the untraced seconds' idle and the profiler's.
    assert sum(notes["idle_by_span"].values()) == pytest.approx(
        UNTRACED_S - notes["busy_s"] + notes["profiler_excess_s"])
    assert notes["program_counts_per_outer"] == {"proj.fwd": 3.0,
                                                 "sync": 3.0}


@pytest.mark.parametrize("name", READERS)
def test_readers_read_the_join(name):
    reader = importlib.import_module(f"portbench.metrics.{name}")
    j = _joined()
    assert reader.read(_ctx(j)) == pytest.approx(getattr(j, name)())


@pytest.mark.parametrize("name", JOINERS)
def test_readers_refuse_misaligned_clocks(name):
    reader = importlib.import_module(f"portbench.metrics.{name}")
    j = _joined(shift=10**6)
    assert j.alignment() == 0.0
    assert reader.read(_ctx(j)) is None


@pytest.mark.parametrize("name", JOINERS)
def test_readers_refuse_an_incomplete_trace(name):
    reader = importlib.import_module(f"portbench.metrics.{name}")
    j = _joined(device=DEVICE[:-2])  # the history's forward lost its record
    assert not j.records.complete()
    assert j.lost_by_span() == {"proj.fwd cudaLaunchKernel": 1}
    assert reader.read(_ctx(j)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_a_trace(name):
    import torch

    reader = importlib.import_module(f"portbench.metrics.{name}")
    ctx = types.SimpleNamespace(trace=None, device=torch.device("cpu"))
    assert reader.read(ctx) is None


def test_records_keep_the_window():
    # A launch after the window, its record lost, and a record of a launch
    # before it: neither is the window's.
    host = HOST + [(1005, 1006, "cudaLaunchKernel", 9),
                   (-9, -8, "cudaLaunchKernel", 10)]
    dev = DEVICE + [(-5, 20, "early", (10,))]
    rec = spans.Records(dev, host, 0, 1000)
    assert rec.complete() and len(rec.launches) == 5
    assert [d[2] for d in rec.device] == [d[2] for d in DEVICE]


def test_innermost_edges():
    s = _spans()
    got = spans.innermost(s, [-1, 0, 100, 599, 600, 1000, 455])
    assert [g.name if g else None for g in got] == [
        None, "admm.run", "admm.outer", "admm.outer", "admm.run", None,
        "proj.fwd"]
