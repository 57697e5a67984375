"""vcycle_ms (ms): the V-cycle a batch on the host's clock (its labels come
back to the host once a batch), stats.ml_time_s / stats.n_batches summed
over the untraced jobs."""


def read(ctx):
    batches = sum(j.n_batches for j in ctx.jobs)
    return sum(j.ml_time_s for j in ctx.jobs) / batches * 1e3 if batches else None
