"""Kernel launches per image-outer: the host's kernel-launch calls in the
profiler's trace of the traced window over the image-outers (a batch of B
counts B an outer) it completed. None where the trace holds fewer launch
calls than the program's counters of its own kernel wrappers' launches in
the same window, or a launch lacks its device record."""


def read(ctx):
    t = ctx.trace
    if not t.complete() or ctx.image_outers == 0 \
            or t.launches < sum(ctx.counters.values()):
        return None
    return t.launches / ctx.image_outers
