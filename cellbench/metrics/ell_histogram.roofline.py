"""ell_histogram.roofline (%): the `ell_histogram` kernel's launches in the
traced job, their least time at the card's memory rate (the yardstick's
frozen byte count from each launch's (B, W, k)) over their device time
(the profiler's rows of the kernel `hist_kernel`).  Nothing where the
kernel did not launch."""
from cellbench.harness import yardstick

KERNEL = "hist_kernel"


def read(ctx):
    launches = ctx.launches.get("ell_histogram", [])
    if ctx.trace is None or not launches:
        return None
    bound = 0.0
    for args, _ in launches:
        (b, w), k = args[0], args[2]
        bound += yardstick.bound_s(yardstick.hist_bytes(b, w, k))
    device = sum(v[0] for name, v in ctx.trace.rows.items() if KERNEL in name)
    return 100.0 * bound / device if device > 0 else None
