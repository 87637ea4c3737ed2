"""The fan rebin's device time per image-outer: the device ms of the
records launched inside ``proj.rebin`` spans (each fan projector call's
flip periodization, angular rebin and row mask, forward and adjoint; the
parallel stage's K1-K4 lie outside it) that lie inside ``admm.outer``
spans, so the fcv build is left out, over the image-outers of a traced
window (``portbench.spans``). None where the join cannot be trusted or
holds no ``proj.rebin`` span: a parallel-beam cell, or a program that
does not record it."""

from portbench import spans


def device_ms_per_outer(ctx, names) -> float | None:
    """Device ms of the records launched inside a span named in ``names``
    inside ``admm.outer``, over the image-outers; None where the join
    cannot be trusted or lacks a span of one of the ``names``."""
    j = spans.trusted(ctx)
    if j is None or not j.image_outers \
            or not set(names) <= {s.name for s in j.spans}:
        return None
    dev = j.records.device
    where = spans.innermost(j.spans,
                            [j.records.launched_at(d) or d[0] for d in dev])
    ns = 0
    for d, s in zip(dev, where):
        if s is None:
            continue
        c = j.chain(s)
        if "admm.outer" in c and any(n in names for n in c):
            ns += d[1] - d[0]
    return 1e-6 * ns / j.image_outers


def read(ctx):
    return device_ms_per_outer(ctx, ("proj.rebin",))
