"""The node solver's own device time per image-outer: the device ms of the
records whose innermost span at launch is ``node.solve`` itself (the inner
steps' and the checks' own kernels: the Condat-Vu step, fcv's metric, the
residual's TV terms), inside ``admm.outer`` spans, over the image-outers of
a traced window (``portbench.spans``). Records launched in a span nested in
``node.solve`` (``proj.*``, ``sync``, ``node.tail``) are not counted. None
where the join cannot be trusted or holds no ``node.solve`` span."""

from portbench import spans


def read(ctx):
    j = spans.trusted(ctx)
    if j is None or not j.image_outers \
            or "node.solve" not in {s.name for s in j.spans}:
        return None
    dev = j.records.device
    where = spans.innermost(j.spans,
                            [j.records.launched_at(d) or d[0] for d in dev])
    ns = sum(d[1] - d[0] for d, s in zip(dev, where)
             if s is not None and s.name == "node.solve"
             and "admm.outer" in j.chain(s))
    return 1e-6 * ns / j.image_outers
