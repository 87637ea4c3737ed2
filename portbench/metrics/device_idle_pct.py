"""The device's idle share of the reconstructions: 100 (1 - busy /
untraced), busy the union of the device's kernel, copy and set intervals
in the profiler's trace of the traced reconstructions, untraced the host
seconds of as many reconstructions just before, with the profiler off
(the profiler slows the host, which would add idle time of its own).
None where a kernel launch in the trace lacks its device record, which
would understate the busy time."""


def read(ctx):
    t = ctx.trace
    if t.untraced_s <= 0 or not t.complete():
        return None
    return 100.0 * (1.0 - t.busy_s / t.untraced_s)
