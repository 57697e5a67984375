"""facade_ms (ms): the front door's own time in a job, the API's
provenance `runtime_s` less the driver's `stats.runtime_s`; the median
over the untraced jobs."""
import statistics


def read(ctx):
    return statistics.median((j.provenance_runtime_s - j.runtime_s) * 1e3 for j in ctx.jobs)
