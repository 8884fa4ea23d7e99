"""Microbench: int8 vs bf16 tensor-core rate of the chained GEMM kernel.

Port of ``scripts/bench_int8_gemm.py``. Decides whether an int8 variant of
the fused ViT block is worth building: each mode runs a CHAIN of square
matmuls (x <- f(x @ W)) and each step includes the dtype's realistic
epilogue: bf16 casts the fp32 accumulator back to bf16; int8 re-quantizes
per row (max-abs -> scale -> round) — the same epilogue a quantized block
kernel would pay between layers — or, as a lower bound on the epilogue,
shifts.

Usage: python -m vittf_tpu_torch.scripts.bench_int8_gemm [--rows 2048]
       [--dim 1536] [--chain 32] [--iters 20] [--cpu]

Runs ``ops.chain_gemm`` on the first CUDA device (timed with CUDA events
after a warm-up) and raises when none is visible; ``--cpu`` runs the plain
version on the CPU (host clock), for tests at a small size.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vittf_tpu_torch.ops.chain_gemm import chain_gemm


def make_inputs(rows: int, dim: int, device) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """The probe's operands per mode, drawn from ``default_rng(0)`` in the
    order the JAX probe draws them."""
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((rows, dim))).to(torch.bfloat16)
    wb = torch.from_numpy(rng.standard_normal((dim, dim)) / np.sqrt(dim)).to(torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-127, 128, (rows, dim))).to(torch.int8)
    wi = torch.from_numpy(rng.integers(-8, 9, (dim, dim))).to(torch.int8)
    xb, wb, xi, wi = (t.to(device) for t in (xb, wb, xi, wi))
    return {"bf16": (xb, wb), "int8+requant": (xi, wi), "int8+shift": (xi, wi)}


def run(name: str, x: torch.Tensor, w: torch.Tensor, chain: int, iters: int) -> float:
    """Seconds per call of ``chain_gemm`` in mode ``name``; prints one line."""
    out = chain_gemm(x, w, chain, name)  # warm-up: builds the kernels on first use
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            out = chain_gemm(x, w, chain, name)
        end.record()
        torch.cuda.synchronize(x.device)
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = chain_gemm(x, w, chain, name)
        dt = (time.perf_counter() - t0) / iters
    if out.shape != x.shape or out.dtype != x.dtype:
        raise AssertionError(f"{name}: result {tuple(out.shape)} {out.dtype}")
    flops = 2 * x.shape[0] * w.shape[0] * w.shape[1] * chain
    print(f"{name:>14}: {dt * 1e3:8.3f} ms  {flops / dt / 1e12:6.1f} Tops/s")
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=1536)
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="Run the plain version on the CPU")
    args = ap.parse_args(argv)

    from vittf_tpu_torch.cli.infer import select_device

    inputs = make_inputs(args.rows, args.dim, select_device(args.cpu))
    t_bf = run("bf16", *inputs["bf16"], args.chain, args.iters)
    t_i8 = run("int8+requant", *inputs["int8+requant"], args.chain, args.iters)
    t_i8n = run("int8+shift", *inputs["int8+shift"], args.chain, args.iters)
    print(f"speedup int8+requant vs bf16: {t_bf / t_i8:.2f}x")
    print(f"speedup int8+shift   vs bf16: {t_bf / t_i8n:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
