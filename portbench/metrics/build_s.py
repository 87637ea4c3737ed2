"""Host seconds of ``data.loader.build_problem`` (tables, data, column
norms, graph, operator norms), synchronized."""


def read(ctx):
    return ctx.build_s
