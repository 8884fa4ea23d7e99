"""K3 (``csrc/fused_block.cu``): the blocks' least time at the bf16 peak
over the time of the kernel's launches in the trace."""
from portbench.harness import flops

KERNELS = (r"linear_resident_kernel|linear_ring_kernel|qkv_attention_kernel"
           r"|(?<![A-Za-z_])layer_norm_kernel")


def read(ctx):
    return flops.roofline_share(ctx, "fused_block", KERNELS, flops.PEAK_BF16_FLOPS)
