"""The reader of the node solver's own device time (``solve_ms_per_outer``)
on a synthetic join whose answer is known: one reconstruction of one outer
whose ``node.solve`` launches kernels of its own and inside ``proj.fwd``,
``proj.adj``, ``sync`` and ``node.tail``; a ``node.solve`` outside any
``admm.outer`` (a solve the consensus loop does not run) besides. Times in
ns."""

import importlib
import types

import pytest

from portbench import spans
from dip_admm_tpu_torch.utils.profiling import Span


def _spans(shift=0, drop=()):
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
        (10, 6, "node.tail", 350, 395),
        (11, 5, "admm.consensus", 400, 450),
        (12, 5, "sync", 550, 590),
        (13, 1, "node.solve", 700, 900),
    ]
    return [Span(i, p, 1, n, a + shift, b + shift, {})
            for i, p, n, a, b in rows if n not in drop]


# Host runtime calls (start, end, name, correlation id) and the device's
# records (start, end, name, correlation ids).
HOST = [(25, 27, "cudaLaunchKernel", 1), (85, 86, "cudaMemcpyAsync", 2),
        (115, 116, "cudaLaunchKernel", 3), (125, 127, "cudaLaunchKernel", 4),
        (165, 166, "cudaLaunchKernel", 5), (210, 211, "cudaLaunchKernel", 6),
        (250, 251, "cudaLaunchKernel", 7), (305, 306, "cudaMemcpyAsync", 8),
        (360, 361, "cudaLaunchKernel", 9), (398, 399, "cudaLaunchKernel", 10),
        (410, 412, "cudaLaunchKernel", 11), (560, 561, "cudaMemcpyAsync", 12),
        (710, 711, "cudaLaunchKernel", 13)]
DEVICE = [(30, 60, "skew_fwd", (1,)), (90, 91, "Memcpy DtoH", (2,)),
          (117, 124, "cv_grad", (3,)), (130, 160, "skew_fwd", (4,)),
          (170, 200, "skew_t", (5,)), (212, 228, "fft", (6,)),
          (252, 263, "cv_update", (7,)), (310, 312, "Memcpy DtoH", (8,)),
          (362, 392, "objective_fwd", (9,)), (400, 405, "residual", (10,)),
          (415, 430, "K5", (11,)), (565, 566, "Memcpy DtoH", (12,)),
          (712, 800, "cv_grad", (13,))]
UNTRACED_S = 1e-6

# node.solve's own records inside admm.outer: 7 + 16 + 11 + 5 ns (the
# projector's, the check's copy and node.tail's left out; the solve outside
# admm.outer too).
KNOWN = 39e-6


def _joined(shift=0, device=DEVICE, drop=()):
    rec = spans.Records(device, HOST, 0, 1000)
    return spans.Joined(rec, _spans(shift, drop), {"sync": 3}, 1, UNTRACED_S)


def _ctx(j):
    return types.SimpleNamespace(_spans_joined=j)


def _read(j):
    return importlib.import_module(
        "portbench.metrics.solve_ms_per_outer").read(_ctx(j))


def test_known_answer():
    j = _joined()
    assert j.trusted()
    assert _read(j) == pytest.approx(KNOWN)


@pytest.mark.parametrize("name,ns", [("proj.fwd", 30), ("proj.adj", 30),
                                     ("node.tail", 30)])
def test_nested_spans_are_not_counted(name, ns):
    # Without the nested span its records fall to node.solve itself.
    assert _read(_joined(drop=(name,))) == pytest.approx(KNOWN + 1e-6 * ns)


def test_only_inside_the_outers():
    j = _joined(drop=("admm.outer",))
    assert _read(j) == pytest.approx(0.0)


def test_none_without_the_solve_span():
    assert _read(_joined(drop=("node.solve",))) is None


def test_none_on_misaligned_clocks():
    j = _joined(shift=10**6)
    assert j.alignment() == 0.0
    assert _read(j) is None


def test_none_on_an_incomplete_trace():
    j = _joined(device=DEVICE[:-1])  # a launch lost its record
    assert not j.records.complete()
    assert _read(j) is None


def test_none_without_a_trace():
    import torch

    ctx = types.SimpleNamespace(trace=None, device=torch.device("cpu"))
    assert importlib.import_module(
        "portbench.metrics.solve_ms_per_outer").read(ctx) is None
