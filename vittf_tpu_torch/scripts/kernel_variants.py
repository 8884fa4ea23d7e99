"""Build edited copies of the CUDA sources on the card and run a check or a
timer with each: the planted faults that show a kernel check catches a wrong
kernel, and the ablations behind the notes on what bounds K1 and K2.

    python3 -m vittf_tpu_torch.scripts.kernel_variants faults [--only K1]
    python3 -m vittf_tpu_torch.scripts.kernel_variants attention-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants similarity-ablation

Run from the repository's root on a machine with one GPU and ``nvcc``: the
checks are ``chip_smoke.py``'s phases. Each variant copies
``vittf_tpu_torch/csrc`` into a temporary directory, applies its text edits
(every ``old`` string must occur exactly once), points ``kernels.CSRC`` at the
copy and loads the library it builds (the library's name carries the sources'
hash, so each copy builds its own); the repository's sources are never edited.
A fault prints ``FAILED <name>: <what the phase raised>`` when the phase
catches it, which is the wanted outcome, and ``PASSED <name>`` when it does
not; an ablation prints ``PASSED <name>: <times in ms>``.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

AC, SIM, BL, RB, SO = ("attention_core.cuh", "similarity.cu", "bilateral.cu",
                       "bilateral_reblock.cu", "splat_ordered.cuh")

# (name, chip_smoke phase, [(file, old, new), ...]); a phase without edits is the control
FAULTS = [
    ("control: no edit", "attention", []),
    ("K1 skip the alpha rescale of the output", "attention",
     [(AC, "      rescale(acc, lsum, alpha);\n", "      ;\n")]),
    ("K1 mask with 0 instead of -inf", "attention",
     [(AC, "if (key0 + 8 * j + (e & 1) >= n_valid) s[j][e] = -CUDART_INF_F;",
       "if (key0 + 8 * j + (e & 1) >= n_valid) s[j][e] = 0.f;")]),
    ("K1 drop the last K tile", "attention",
     [(AC, "  const int n_tiles = (n_valid + kBk - 1) / kBk;\n",
       "  const int n_tiles = (n_valid + kBk - 1) / kBk - (n_valid > kBk ? 1 : 0);\n")]),
    ("K1 running sum not rescaled", "attention",
     [(AC, "  lsum[0] *= alpha[0];\n  lsum[1] *= alpha[0];\n  lsum[2] *= alpha[1];\n"
           "  lsum[3] *= alpha[1];\n", "")]),
    ("K1 V key step 1024 bytes instead of 2048", "attention",
     [(AC, "tile_desc(v_s + kk * 2048)", "tile_desc(v_s + kk * 1024)")]),
    ("K1 row sums read before the product that takes them has finished", "attention",
     [(AC, "  issue_pv(n_tiles - 1);\n  wgmma_wait<0>(acc);\n  pin(lsum);\n",
       "  issue_pv(n_tiles - 1);\n")]),
    ("K1 ones operand left unfilled", "attention",
     [(AC, "0x3F803F80u;  // bf16 1.0, twice", "0u;")]),
    ("control: no edit", "similarity", []),
    ("K2 skip the last feature slab", "similarity",
     [(SIM, "#pragma unroll\n    for (int k = 0; k < kBk; k += 4) {\n      float4 y[kAj];",
       "    if (slab + 1 < n_slabs)\n#pragma unroll\n    for (int k = 0; k < kBk; k += 4) {\n"
       "      float4 y[kAj];")]),
    ("K2 > for >= at the threshold", "similarity",
     [(SIM, "            const bool pass = row[j] >= threshold;",
       "            const bool pass = row[j] > threshold;")]),
    ("K2 wrong M row in later chunks", "similarity",
     [(SIM, "const float* m_row = mmat + (int64_t)a_first * C + c0;",
       "const float* m_row = mmat + (int64_t)(a_first / 2) * C + c0;")]),
    ("K2 chain reads the neighbouring voxel's scores", "similarity",
     [(SIM, "const float gx = tb[v * kTbPitch + x];",
       "const float gx = tb[(v ^ 1) * kTbPitch + x];")]),
    ("K2 contraction summed per group first (not one chain)", "similarity",
     [(SIM, "            sum[k] = c0 + 2 * k < C ? os[(c0 + 2 * k) * kBn + w0 + v] : 0.f;",
       "            sum[k] = 0.f;"),
      (SIM, "os[(c0 + 2 * k) * kBn + w0 + v] = sum[k];",
       "os[(c0 + 2 * k) * kBn + w0 + v] += sum[k];")]),
    ("control: no edit", "bilateral", []),
    ("K4 staging order reversed", "bilateral",
     [(BL, "        stages[warp][lane] = splat_ordered::staged((int)(luma[v] / sigma_luma)",
       "        stages[warp][min(32, n - i0) - 1 - lane] = "
       "splat_ordered::staged((int)(luma[v] / sigma_luma)")]),
    ("K4 drop the last voxel of a cell", "bilateral",
     [(BL, "    const int n = nz * ny * nx;", "    const int n = nz * ny * nx - 1;")]),
    ("K4 t not multiplied by c", "bilateral",
     [(BL, "__fmul_rn(target[v], c));", "target[v]);")]),
    ("K4 bin by reciprocal multiply", "bilateral",
     [(BL, "splat_ordered::staged((int)(luma[v] / sigma_luma)",
       "splat_ordered::staged((int)(luma[v] * (1.f / sigma_luma))")]),
    ("K7a staging order reversed", "bilateral",
     [(RB, "      stages[warp][lane] = splat_ordered::staged(il[base + i]",
       "      stages[warp][min(32, cell_pixels - i0) - 1 - lane] = "
       "splat_ordered::staged(il[base + i]")]),
    ("K7a drop the last slot of a cell", "bilateral",
     [(RB, "    if (i < cell_pixels)\n      stages", "    if (i < cell_pixels - 1)\n      stages")]),
    ("K7a c and t*c planes swapped", "bilateral",
     [(RB, "L, c[base + i], tc[base + i]);", "L, tc[base + i], c[base + i]);")]),
    ("K4+K7a a lane owns the neighbouring bin", "bilateral",
     [(SO, "        if (b == lane + 32 * u) {", "        if (b == lane + 32 * u + 1) {")]),
]

# K1 at (8, 6, 4097, 64) bf16 with one part of its loop taken out: what the
# part costs (the results are wrong, only the times count)
ATTENTION_ABLATION = [
    ("whole kernel", []),
    ("no exp2 (p = x)", [(AC, '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "  y = x;")]),
    ("no K/V copies after the first tiles",
     [(AC, "    load_kv(tile + kStages - 1);  // into the slot tile - 1 used",
       "    cp_async_commit();")]),
    ("no p.v product", [(AC, "      wgmma_rs<true>(acc, pf[kk], tile_desc(v_s + kk * 2048), 1);",
                         "      ;")]),
    ("no row sums on the tensor cores",
     [(AC, "      wgmma_rs_n8(lsum, pf[kk], tile_desc(ones_s));", "      lsum[0] = lsum[2] = 1.f;")]),
    ("no scores product after tile 0",
     [(AC, "    issue_scores(tile + 1);\n", "    wgmma_fence();\n    wgmma_commit();\n")]),
    ("no softmax in the loop",
     [(AC, "    softmax_step<kMax, kPreScaled>(s, m, alpha, pf, scale_log2);\n    if (kMax && __any",
       "    alpha[0] = alpha[1] = 1.f;\n    if (kMax && __any")]),
    ("whole kernel, again", []),
]

# K2 at the request's shape: the cost of g's two devices
SIMILARITY_ABLATION = [
    ("whole kernel", []),
    ("g never skipped", [(SIM, "        if (__any_sync(0xffffffffu, any)) {",
                          "        if (__any_sync(0xffffffffu, true)) {")]),
    ("g by x*x*sqrt(x) instead of powf (other bits)",
     [(SIM, "            const float pw = powf(pass ? row[j] : 1.f, exponent);",
       "            const float xx = pass ? row[j] : 1.f; const float pw = xx * xx * sqrtf(xx);")]),
    ("g unrolled over all 16 rows: 128 copies of powf",
     [(SIM, "#pragma unroll 1\n      for (int turn = 0; turn < kVi; ++turn) {",
       "#pragma unroll\n      for (int turn = 0; turn < kVi; ++turn) {")]),
    ("whole kernel, again", []),
]


def _time_attention(cs, torch):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(cs.ATTN_SHAPE, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    ours = [round(cs.cuda_ms(lambda: cs.attention(q, k, v), reps=21), 4) for _ in range(3)]
    lib = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), reps=21)
    return f"kernel {ours} ms, scaled_dot_product_attention {round(lib, 4)} ms"


def _time_similarity(cs, torch):
    gen = torch.Generator().manual_seed(0)
    feats, queries, m = cs.similarity_case(gen, cs.SIM_N, [cs.SIM_PER_CLASS] * cs.SIM_C)
    out = []
    for mean_first in (False, True):
        ms = cs.cuda_ms(lambda: cs.similarity(feats, queries, m, mean_first=mean_first))
        out.append(f"mean_first={mean_first} {round(ms, 3)} ms")
    return ", ".join(out)


def run_variant(name, edits, check, kernels) -> bool:
    """Build ``edits`` into a copy of the sources and run ``check`` with the
    copy's library loaded; prints the verdict, returns whether it passed."""
    import torch

    orig = kernels.CSRC
    tmp = Path(tempfile.mkdtemp(prefix="vittf_variant_"))
    try:
        shutil.copytree(orig, tmp / "csrc")
        for fname, old, new in edits:
            path = tmp / "csrc" / fname
            text = path.read_text()
            if text.count(old) != 1:
                print(f"EDIT DOES NOT APPLY {name}: {old!r} occurs {text.count(old)} times "
                      f"in {fname}")
                return False
            path.write_text(text.replace(old, new))
        kernels.CSRC, kernels._lib = tmp / "csrc", None
        try:
            kernels.load_library()
            out = check()
            print(f"PASSED {name}: {out if isinstance(out, str) else ''}")
            return True
        except (AssertionError, RuntimeError) as e:
            print(f"FAILED {name}: {str(e)[:300]}")
            return False
        finally:
            torch.cuda.synchronize()
    finally:
        kernels.CSRC, kernels._lib = orig, None
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["faults", "attention-ablation", "similarity-ablation"])
    ap.add_argument("--only", default="", help="run the variants whose name starts with this")
    args = ap.parse_args(argv)

    import torch

    from vittf_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line())
    if args.what == "faults":
        todo = [(name, edits, lambda p=phase: getattr(cs, "phase_" + p)(
            torch.Generator().manual_seed(0))) for name, phase, edits in FAULTS]
    elif args.what == "attention-ablation":
        todo = [(n, e, lambda: _time_attention(cs, torch)) for n, e in ATTENTION_ABLATION]
    else:
        todo = [(n, e, lambda: _time_similarity(cs, torch)) for n, e in SIMILARITY_ABLATION]
    caught = missed = 0
    for name, edits, check in todo:
        if not name.startswith(args.only) and not name.startswith("control"):
            continue
        passed = run_variant(name, edits, check, kernels)
        if edits and args.what == "faults":
            caught, missed = caught + (not passed), missed + passed
    if args.what == "faults":
        print(f"planted faults: {caught} caught, {missed} not caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
