"""K10 (``csrc/swiglu.cu``): the SwiGLU gate launches' least time (6·M·H
bytes each at the HBM rate: the gate is bound by memory) over the kernel's
time in the trace."""
from portbench.harness import flops

KERNELS = r"swiglu_gate_kernel"


def read(ctx):
    return flops.roofline_share(ctx, "swiglu", KERNELS, flops.PEAK_BF16_FLOPS)
