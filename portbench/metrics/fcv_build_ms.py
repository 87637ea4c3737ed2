"""The fcv preconditioner's build a reconstruction (the PSF pair, 25
Lanczos pairs, eigvalsh): from the start of each ``admm.fcv_build`` span
to the later of its end and the device's end of the last kernel launched
inside it, the median over a traced window (``portbench.spans``). None
where the join cannot be trusted or no reconstruction builds one."""

from portbench import spans


def read(ctx):
    j = spans.trusted(ctx)
    return None if j is None else j.fcv_build_ms()
