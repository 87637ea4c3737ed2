"""Profiling hooks: the program's spans and counters, and a Chrome trace.

``span(name, **attrs)`` marks a phase of the program and ``count(name,
n)`` counts an event; both sit on the hot path and do nothing unless a
recorder is open. ``recording()`` opens one: spans then carry host times
on the clock of ``torch.profiler``'s records (Unix-epoch nanoseconds), so
that a trace's kernels can be put down to the phase that launched them.
Neither ever launches a kernel, synchronizes or reads device state.

``trace(log_dir)`` records the enclosed region with ``torch.profiler``
(host activity, and the device's where CUDA is available) and with the
program's spans, and writes a Chrome trace (``trace.json``, open it in
chrome://tracing or Perfetto) into ``log_dir``, the spans on a track of
their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

import torch

# The open recorder, or None: the one test of the hot path.
_REC = None


class Span(NamedTuple):
    """One closed span. ``id`` counts from 1 in a recorder; ``parent`` is
    the enclosing span's id and ``run`` the id of the enclosing
    ``admm.run`` span (its own for that span), each None outside one."""

    id: int
    parent: int | None
    run: int | None
    name: str
    t0_ns: int  # Unix-epoch ns, the profiler's clock
    t1_ns: int
    attrs: dict


class Recorder:
    """The spans and counts of one ``recording()`` region, kept in memory:
    ``spans`` in the order they closed, ``counts`` {name: int}. Spans are
    recorded on the thread that opened the recorder alone."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.thread = threading.get_ident()
        # perf_counter ns -> the profiler's epoch ns, taken once.
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._stack: list[_OpenSpan] = []
        self._next = 1


class _NoSpan:
    """The span of every site while no recorder is open."""

    __slots__ = ()

    @property
    def attrs(self) -> dict:
        """A dict that nothing keeps: attributes set late go nowhere."""
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "run", "t0")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.id = rec._next
        rec._next += 1
        top = rec._stack[-1] if rec._stack else None
        self.parent = top.id if top is not None else None
        self.run = (self.id if self.name == "admm.run"
                    else top.run if top is not None else None)
        rec._stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stack.pop()  # with-statements close spans innermost first
        off = rec.offset_ns
        rec.spans.append(Span(self.id, self.parent, self.run, self.name,
                              self.t0 + off, t1 + off, self.attrs))
        return False


def span(name: str, /, **attrs):
    """A context manager marking a phase ``name`` of the program."""
    rec = _REC
    if rec is None:
        return _NO_SPAN
    if threading.get_ident() != rec.thread:
        return _NO_SPAN
    return _OpenSpan(rec, name, attrs)


def count(name: str, /, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open recorder."""
    rec = _REC
    if rec is None:
        return
    rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record the program's spans and counts in the enclosed region; yields
    the ``Recorder``. A recorder opened inside another takes the region's
    spans, and the outer one resumes after it."""
    global _REC
    prev, rec = _REC, Recorder()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = prev


# The Chrome trace's track of the program's spans.
SPAN_TID, SPAN_TRACK = 1, "dip_admm_tpu_torch spans"


def spans_as_chrome(spans, base_ns: int, pid: int) -> list:
    """Complete events ("ph": "X", microseconds from ``base_ns``) of
    ``spans`` on the track SPAN_TID of process ``pid``."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
            "args": {"name": SPAN_TRACK}}]
    for s in sorted(spans, key=lambda s: s.t0_ns):
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": SPAN_TID,
                    "ts": (s.t0_ns - base_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "run": s.run,
                             **{k: repr(v) if not isinstance(
                                 v, (int, float, str, bool)) else v
                                for k, v in s.attrs.items()}}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into ``<log_dir>/trace.json``, with the
    program's spans."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(spans_as_chrome(
        rec.spans, int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)
