"""nodes_per_s (nodes/s): every node of the window's jobs over the time of
those jobs, each timed on the host's clock around `partition` and its
last wait on the card."""


def read(ctx):
    return sum(j.n for j in ctx.jobs) / sum(j.wall_s for j in ctx.jobs)
