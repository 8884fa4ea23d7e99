"""K2 (``csrc/similarity.cu``): the edits' similarity at the fp32 peak (the
kernel computes in IEEE fp32) over the kernel's time in the trace."""
from portbench.harness import flops

KERNELS = r"similarity_kernel"


def read(ctx):
    return flops.roofline_share(ctx, "similarity", KERNELS, flops.PEAK_FP32_FLOPS)
