"""Share of the traced slice in which no device operation ran (kernels,
copies, memsets), from the profiler's device events."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
