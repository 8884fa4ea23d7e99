"""Share of the traced edit window in which the card ran nothing."""


def read(ctx):
    if ctx.trace is None or "similarity" not in ctx.work:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
