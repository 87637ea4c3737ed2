"""The traced window: ``torch.profiler`` (device activity only, so the host
pays little for it) over whole reconstructions, and what is read from its
trace: the device's busy seconds (the union of its kernel, copy and set
intervals), the host's kernel-launch calls, whether every launch the host
made has its device record (the profiler can lose records, which would
understate the busy time), the device operations that took most time and
the longest idle gaps, each labelled by the host's runtime calls on
either side of it.
"""

from __future__ import annotations

import bisect
import time

import torch

# A device operation's name is cut to this many characters.
NAME_CHARS = 120
# Device records that are copies or sets, not kernels.
COPY_SET = ("Memcpy", "Memset")
# Host-side runtime and driver calls that launch a kernel.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals (in their unit)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Trace:
    """What the harness reads from one traced window (the profiler's
    records, ``prof.profiler.kineto_results.events()``)."""

    def __init__(self, events, window_s: float, untraced_s: float):
        from torch.autograd import DeviceType

        self.window_s, self.untraced_s = window_s, untraced_s
        dev, host = [], []
        launch_ids, kernel_ids = [], set()
        for e in events:
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                dev.append(rec)
                if not e.name().startswith(COPY_SET):
                    kernel_ids.update((e.correlation_id(),
                                       e.linked_correlation_id()))
            else:
                host.append(rec)
                if e.name() in LAUNCH_CALLS:
                    launch_ids.append(e.correlation_id())
        kernel_ids.discard(0)
        self.device, self.host = sorted(dev), sorted(host)
        self.busy_s = 1e-9 * union_s((a, b) for a, b, _ in self.device)
        self.launches = len(launch_ids)
        # Launches made whose kernel the device's records lack.
        self.unrecorded = sum(1 for i in launch_ids if i not in kernel_ids)

    def complete(self) -> bool:
        """Every kernel launch in the trace has its device record."""
        return self.launches > 0 and self.unrecorded == 0

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...]: the device operations by total time."""
        by: dict = {}
        for a, b, n in self.device:
            by[n[:NAME_CHARS]] = by.get(n[:NAME_CHARS], 0.0) + 1e-9 * (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[label, seconds], ...]: the longest gaps between the device's
        busy intervals, each labelled "<host call before it> -> <host call
        that ended it>"."""
        gaps, end = [], None
        for a, b, _ in self.device:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        starts = [h[0] for h in self.host]
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            i1 = bisect.bisect_right(starts, g1) - 1
            i0 = bisect.bisect_right(starts, g0) - 1
            before = self.host[i0][2] if i0 >= 0 else "start"
            after = self.host[i1][2] if i1 >= 0 else "start"
            out.append([f"{before} -> {after}", 1e-9 * (g1 - g0)])
        return out


def traced(fn, device, untraced_s: float) -> Trace:
    """Run ``fn()`` under the profiler; the window is the host's seconds
    from its start to the device's end of its work. ``untraced_s`` is the
    host's seconds for the same work with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), window_s, untraced_s)
