"""Host seconds to build (nvcc, on a checkout's first run only) and load
the cell's kernel libraries."""


def read(ctx):
    return ctx.kernel_load_s
