"""Similarity FLOPs of the traced window's edits (the dirty classes' real
annotations), as a share of the fp32 peak over the window's wall time."""
from portbench.harness import flops


def read(ctx):
    if ctx.trace is None or "similarity_flops" not in ctx.work:
        return None
    return 100.0 * ctx.work["similarity_flops"] / (ctx.window_s * flops.PEAK_FP32_FLOPS)
