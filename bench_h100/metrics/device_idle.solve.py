"""Share of the traced window of a solve cell in which no operation ran on
the card (the union of device intervals in the profiler's trace)."""


def read(ctx):
    if ctx.unit != "solve" or ctx.trace is None or not ctx.trace.by_name:
        return None
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
