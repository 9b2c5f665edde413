"""K1's share of its roofline in the fused solve: the least time of one
solve's K1 launches (counts/k1.py, from the schedule and batch alone) over
K1's device time per solve in the trace."""


def read(ctx):
    if ctx.unit != "solve":
        return None
    return ctx.roofline("k1")
