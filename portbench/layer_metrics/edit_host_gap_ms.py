"""Milliseconds an edit in which the card ran nothing while the host was
inside the program's update or predict (``vittf.session.update`` and
``vittf.session.predict`` spans), over the count of updates: the idle the
session's host path leaves, the harness's label fetch and painter left
out."""
from portbench.layer_metrics.extract_host_gap_share import idle_seconds, spans


def read(ctx):
    if ctx.trace is None:
        return None
    updates = len(spans(ctx.trace, "session.update"))
    if not updates:
        return None
    a = spans(ctx.trace, "session.update", "session.predict")
    return 1e3 * idle_seconds(ctx.trace, a) / updates
