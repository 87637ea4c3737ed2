"""The fan rebin's kernel launches per image-outer: the host's
kernel-launch calls whose innermost span is a ``proj.rebin`` inside an
``admm.outer``, over the image-outers of a traced window
(``portbench.spans``). The rebin's small DFT einsums and complex products
on [P, m, D] sinograms are launch-bound; this counts what the host pays
for them. None where the join cannot be trusted or holds no
``proj.rebin`` span."""

from portbench import spans

REBIN = "proj.rebin"


def read(ctx):
    j = spans.trusted(ctx)
    if j is None or not j.image_outers \
            or not any(s.name == REBIN for s in j.spans):
        return None
    where = spans.innermost(j.spans, [h[0] for h in j.records.launches])
    n = sum(1 for s in where if s is not None and s.name == REBIN
            and "admm.outer" in j.chain(s))
    return n / j.image_outers
