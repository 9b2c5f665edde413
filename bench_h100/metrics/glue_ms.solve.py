"""Device milliseconds per solve of every operation that is not one of the
port's qct_* kernels: the eager glue (equilibration, transposes, argsort
compaction, slices, merges), from the profiler's device trace."""


def read(ctx):
    if ctx.unit != "solve" or ctx.trace is None or not ctx.trace.by_name:
        return None
    if not ctx.traced_units:
        return None
    return 1e3 * ctx.trace.non_port_s() / ctx.traced_units
