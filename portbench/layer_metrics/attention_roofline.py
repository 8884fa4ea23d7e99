"""K1 (``csrc/attention.cu``): the attention calls' least time at the bf16
peak over the kernel's time in the trace."""
from portbench.harness import flops

KERNELS = r"attention_bf16_kernel|attention_fp32_kernel"


def read(ctx):
    return flops.roofline_share(ctx, "attention", KERNELS, flops.PEAK_BF16_FLOPS)
