"""setup_s (s): from the process's start to the window's, on the host's
clock: imports, the kernels' build or load, the graph, the warm-up."""


def read(ctx):
    return ctx.setup_s
