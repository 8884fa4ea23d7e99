"""ViT FLOPs the traced window executed, as a share of the bf16 peak over
the window's wall time: the whole extraction step's utilization."""
from portbench.harness import flops


def read(ctx):
    if ctx.trace is None or "vit_flops" not in ctx.work:
        return None
    return 100.0 * ctx.work["vit_flops"] / (ctx.window_s * flops.PEAK_BF16_FLOPS)
