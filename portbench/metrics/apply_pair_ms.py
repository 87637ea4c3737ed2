"""One forward and adjoint of the projector on the cell's B x P images, as
every inner step applies them: CUDA events around each pair, the median
of 20 after 3 warm-ups."""


def read(ctx):
    return ctx.pair_ms()
