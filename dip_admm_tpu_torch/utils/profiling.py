"""Profiling and timing hooks.

``trace(log_dir)`` records the enclosed region with ``torch.profiler``
(host activity, and the device's where CUDA is available) and writes a
Chrome trace (``trace.json``, open it in chrome://tracing or Perfetto) into
``log_dir``. ``time_fn`` times a callable after warm-up, synchronizing the
device around each call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> dict:
    """Seconds of ``fn(*args)`` over ``iters`` calls after ``warmup``, each
    call ended by a device synchronize: best, median and mean."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "best_s": times[0],
        "median_s": times[len(times) // 2],
        "mean_s": sum(times) / len(times),
        "iters": iters,
    }
