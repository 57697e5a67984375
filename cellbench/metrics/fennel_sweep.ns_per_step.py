"""fennel_sweep.ns_per_step (ns/step): the `fennel_sweep` kernel's device
time in the traced job (the profiler's rows of `fennel_sweep_kernel`) over
its steps, one a free node of each launch (the yardstick's frozen count).
Nothing where the kernel did not launch."""
from cellbench.harness import yardstick

KERNEL = "fennel_sweep_kernel"


def read(ctx):
    launches = ctx.launches.get("fennel_sweep", [])
    if ctx.trace is None or not launches:
        return None
    steps = sum(yardstick.sweep_steps(args[8]) for args, _ in launches)
    device = sum(v[0] for name, v in ctx.trace.rows.items() if KERNEL in name)
    return device / steps * 1e9 if steps and device > 0 else None
