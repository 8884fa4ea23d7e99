"""K1's RoPE mode (``csrc/attention.cu`` ``rope_attention_kernel``): its
launches' least time at the bf16 peak (4·B·H·N²·hd each, against q, k, v,
o and the RoPE table's bytes) over the kernel's time in the trace."""
from portbench.harness import flops

KERNELS = r"rope_attention_kernel"


def read(ctx):
    return flops.roofline_share(ctx, "rope_attention", KERNELS, flops.PEAK_BF16_FLOPS)
