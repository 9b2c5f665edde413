"""Host milliseconds from a solve's call to its return, before the sync:
the time the entry (solver/fused.py) holds the host,
mean over the untraced part of the window."""


def read(ctx):
    if ctx.unit != "solve":
        return None
    return ctx.result["host_ms"]
