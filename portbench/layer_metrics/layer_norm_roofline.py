"""K11 (``csrc/layer_norm.cu``): the residual + LayerNorm launches' least
time (their rows' bytes at the HBM rate: the kernel is bound by memory)
over the kernel's time in the trace."""
from portbench.harness import flops

KERNELS = r"residual_layer_norm_kernel"


def read(ctx):
    return flops.roofline_share(ctx, "layer_norm", KERNELS, flops.PEAK_BF16_FLOPS)
