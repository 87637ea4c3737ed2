"""The edge state's device time per image-outer: the device ms of the
records launched inside ``admm.neighbours`` (the node problems' terms
from Q, Z and Y) or ``admm.consensus`` (the proposal and K5) spans inside
``admm.outer`` spans, over the image-outers of a traced window
(``portbench.spans``): what the [P, P, n] state costs an outer. None
where the join cannot be trusted or lacks either span."""

from portbench.metrics.rebin_ms_per_outer import device_ms_per_outer


def read(ctx):
    return device_ms_per_outer(ctx, ("admm.neighbours", "admm.consensus"))
