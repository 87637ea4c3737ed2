"""The projector kernels' share of their roofline over one apply pair:
100 x sum(bound ms) / sum(device ms) over every call of a projector
kernel wrapper in the pair, the bound from ``counts/`` at that call's
shapes and the device ms of each call between CUDA events on the device,
its calls queued behind a sleep so that no host time is in them, and the
L2 cache flushed before each (``portbench.run.Context.kernel_calls``)."""


def read(ctx):
    calls = [c for c in ctx.kernel_calls() or [] if c["role"] == "projector"]
    if not calls or any(c["bound_ms"] is None for c in calls):
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) / sum(
        c["ms"] for c in calls)
