"""The projector's device time per image-outer: the device ms of the
kernels launched inside ``proj.fwd``/``proj.adj`` spans that lie inside
``admm.outer`` spans (so the fcv build is left out), over the
image-outers of a traced window (``portbench.spans``). None where the
join cannot be trusted."""

from portbench import spans


def read(ctx):
    j = spans.trusted(ctx)
    return None if j is None else j.proj_ms_per_outer()
