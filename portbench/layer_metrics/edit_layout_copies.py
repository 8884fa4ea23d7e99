"""Copies of the feature volume into the similarity kernel's (V, F) rows
per edit: the program's ``vittf.ntf.layout`` spans (one per such copy) over
its ``vittf.session.update`` spans. 0.0 when the updates made none."""
from portbench.layer_metrics.extract_host_gap_share import spans


def read(ctx):
    if ctx.trace is None:
        return None
    updates = len(spans(ctx.trace, "session.update"))
    if not updates:
        return None
    return float(len(spans(ctx.trace, "ntf.layout"))) / updates
