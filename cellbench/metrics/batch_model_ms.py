"""batch_model_ms (ms): the driver loop and the batch model a batch,
(stats.runtime_s - stats.ml_time_s) / stats.n_batches summed over the
untraced jobs."""


def read(ctx):
    batches = sum(j.n_batches for j in ctx.jobs)
    return sum(j.runtime_s - j.ml_time_s for j in ctx.jobs) / batches * 1e3 if batches else None
