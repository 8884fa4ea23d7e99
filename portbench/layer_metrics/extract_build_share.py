"""Share of the traced extraction window the program spent building its
ViT (the ``vittf.features.build_model`` spans, once per
``extract_features`` call: a CPU module initialised, loaded with the
weights fetched from the card and moved back), during which the card has
next to nothing queued."""
from portbench.layer_metrics.extract_host_gap_share import spans


def read(ctx):
    if ctx.trace is None:
        return None
    a = spans(ctx.trace, "features.build_model")
    if not len(a):
        return None
    return 100.0 * float((a[:, 1] - a[:, 0]).sum()) / 1e6 / ctx.window_s
