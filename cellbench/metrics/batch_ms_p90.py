"""batch_ms_p90 (ms): the 90th percentile, over every batch of the window,
of the time from the batch's nodes being handed to the batch model to its
labels coming back from the V-cycle (the benchmark's host spans)."""
import numpy as np


def read(ctx):
    times = [(end - start) * 1e3 for j in ctx.jobs for start, _, end in j.batches]
    return float(np.percentile(times, 90)) if times else None
