"""Host↔device copies the host waited on per edit: the program's
``vittf.sync.*`` spans (one per such copy) inside its ``vittf.session.*``
spans, over the count of updates."""
import numpy as np

from portbench.layer_metrics.extract_host_gap_share import merged, program_spans, spans


def read(ctx):
    if ctx.trace is None:
        return None
    updates = len(spans(ctx.trace, "session.update"))
    if not updates:
        return None
    session = merged(spans(ctx.trace, "session.update", "session.predict", "session.export"))
    syncs = spans(ctx.trace, *(n for n in program_spans(ctx.trace) if n.startswith("sync.")))
    mids = syncs.mean(axis=1)
    k = np.searchsorted(session[:, 0], mids, side="right") - 1
    inside = (k >= 0) & (mids <= session[np.maximum(k, 0), 1])
    return float(inside.sum()) / updates
