"""Host syncs of the port's loop per image-outer: the program's ``sync``
counter (each site where the host waits for the device: the stop flag or
the running set of an outer, each check of the node solver, its inf test,
fcv's eigvalsh) over the image-outers of a traced window recorded with the
program's spans (``portbench.spans``; a batch of B counts B an outer).
None where the program records no spans."""

from portbench import spans


def read(ctx):
    j = spans.joined(ctx)
    return None if j is None else j.syncs_per_outer()
