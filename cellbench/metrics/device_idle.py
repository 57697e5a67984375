"""device_idle (%): the share of the traced job in which no kernel, copy
or set ran on the card (torch.profiler, CUDA activity)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
