"""Build edited copies of the CUDA sources on the card and run a check or a
timer with each: the planted faults that show a kernel check catches a wrong
kernel, and the ablations behind the notes on what bounds K1, K2, the GEMM
body of K3 and K9, K8, K6a, K6b and K12.

    python3 -m vittf_tpu_torch.scripts.kernel_variants faults [--only K1[,K2...]]
    python3 -m vittf_tpu_torch.scripts.kernel_variants attention-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants similarity-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants gemm-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants bilateral-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants lattice-solve-ablation
    python3 -m vittf_tpu_torch.scripts.kernel_variants graph-faults

Run from the repository's root on a machine with one GPU and ``nvcc``: the
checks are ``chip_smoke.py``'s phases. Each variant copies
``vittf_tpu_torch/csrc`` into a temporary directory, applies its text edits
(every ``old`` string must occur exactly once), points ``kernels.CSRC`` at the
copy and loads the library it builds (the library's name carries the sources'
hash, so each copy builds its own); the repository's sources are never edited.
A fault prints ``FAILED <name>: <what the phase raised>`` when the phase
catches it, which is the wanted outcome, and ``PASSED <name>`` when it does
not; an ablation prints ``PASSED <name>: <times in ms>``. ``graph-faults``
plants its faults in the graph routes (``utils/cuda_graphs.py``, the solve's
key in ``ops/bilateral.py``, the refine core in ``pipeline/refine.py``) by
patching Python names for one run of ``_check_graphs``, with the same
verdicts.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import shutil
import sys
import tempfile
from pathlib import Path

AC, SIM, BL, RB, SO = ("attention_core.cuh", "similarity.cu", "bilateral.cu",
                       "bilateral_reblock.cu", "splat_ordered.cuh")
GC, FB, CG, WC = "gemm_core.cuh", "fused_block.cu", "chain_gemm.cu", "wgmma_common.cuh"
SW, LN = "swiglu.cu", "layer_norm.cu"
BS, LS = "blur_stencil.cuh", "lattice_solve.cu"
RA = "rope_attention.cu"

# (name, chip_smoke phase, [(file, old, new), ...]); a phase without edits is the control.
# A fault must keep every access inside its arrays: a fault of the card (an
# illegal or misaligned address) stays with the process and fails every
# variant after it.
FAULTS = [
    ("control: no edit", "swiglu", []),
    ("K10 halves swapped", "swiglu",
     [(SW, "silu(fa.x) * fb.x, silu(fa.y) * fb.y", "silu(fb.x) * fa.x, silu(fb.y) * fa.y")]),
    ("K10 silu on both halves", "swiglu",
     [(SW, "silu(fa.x) * fb.x, silu(fa.y) * fb.y",
       "silu(fa.x) * silu(fb.x), silu(fa.y) * silu(fb.y)")]),
    ("K10 a row's last vector skipped", "swiglu",
     [(SW, "    const Index c = v - r * hv;\n",
       "    const Index c = v - r * hv;\n    if (c == hv - 1) continue;\n")]),
    ("control: no edit", "layer_norm", []),
    ("K11 gamma dropped", "layer_norm",
     [(LN, "          if (gamma != nullptr) {", "          if (false) {")]),
    ("K11 statistics taken in bf16", "layer_norm",
     [(LN, "const float mu = __fmul_rn(warp_sum(sum), inv_d);",
       "const float mu = round_bf16(__fmul_rn(warp_sum(sum), inv_d));"),
      (LN, "const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));",
       "const float rstd = round_bf16(rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps)));")]),
    ("K11 eps ten times too large", "layer_norm",
     [(LN, "rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));",
       "rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), 10.f * eps));")]),
    ("K11 the residual read after LN (x' written from y)", "layer_norm",
     [(LN, "          x_out[row + c] = to_bf16(v[i]);\n", ""),
      (LN, "        y_out[row + c] = to_bf16(v[i]);\n",
       "        y_out[row + c] = to_bf16(v[i]);\n"
       "        if (RES) x_out[row + c] = to_bf16(v[i]);\n")]),
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
     [(AC, "tile_desc(v_s + u * kSubBytes + kk * 2048)",
       "tile_desc(v_s + u * kSubBytes + kk * 1024)")]),
    ("K1 row sums read before the product that takes them has finished", "attention",
     [(AC, "  issue_pv(n_tiles - 1);\n  wgmma_wait<0>(acc);\n  pin(lsum);\n",
       "  issue_pv(n_tiles - 1);\n")]),
    ("K1 ones operand left unfilled", "attention",
     [(AC, "0x3F803F80u;  // bf16 1.0, twice", "0u;")]),
    ("control: no edit", "rope_attention", []),
    # K1's RoPE mode (rope_attention.cu; its rotation is attention_core.cuh's rope_rotate)
    ("K1 RoPE: K tiles after the first left unrotated", "rope_attention",
     [(RA, "          rotate(ring_s + stage * kStageBytes, kSubBytes, kBk, tile * kBk);",
       "          if (tile == 0) rotate(ring_s + stage * kStageBytes, kSubBytes, kBk, tile * kBk);")]),
    ("K1 RoPE: prefix rows rotated at patch 0's angles", "rope_attention",
     [(AC, "  const int p = abs_row - rope.prefix;\n  if (p < 0 || abs_row >= n_valid) return;",
       "  const int p = max(abs_row - rope.prefix, 0);\n  if (abs_row >= n_valid) return;")]),
    ("K1 RoPE: the column angles where the row angles belong", "rope_attention",
     [(AC, "const int trow = chunk < 4 ? gi : rope.grid_h + (p - gi * rope.grid_w);",
       "const int trow = rope.grid_h + (p - gi * rope.grid_w);")]),
    ("K1 RoPE: V's second 64 dims not multiplied", "rope_attention",
     [(RA, "      for (int u = 0; u < 2; ++u)\n        ac::wgmma_rs<true>",
       "      for (int u = 0; u < 1; ++u)\n        ac::wgmma_rs<true>")]),
    # ... and its pipeline
    ("K1 RoPE: the second consumer computes the first's queries", "rope_attention",
     [(RA, "wc::swz(row + (lane & 15),", "wc::swz(row % 64 + (lane & 15),")]),
    ("K1 RoPE: the ragged tile's -inf mask dropped", "rope_attention",
     [(RA, "    if (decltype(last)::value) ac::mask_tail(s, (tile + 1) * kBk + 2 * t, N);\n", "")]),
    ("K1 RoPE: the producer rotates only the first ring pass", "rope_attention",
     [(RA, "          rotate(ring_s + stage * kStageBytes, kSubBytes, kBk, tile * kBk);",
       "          if (tile < kStages) rotate(ring_s + stage * kStageBytes, kSubBytes, kBk, tile * kBk);")]),
    ("K1 RoPE: K's dims 64-127 loaded from dims 0-63", "rope_attention",
     [(RA, "tma_box(k_s + u * kSubBytes, k_map, bar(kKLanded + stage), u * 64, tile * kBk, h, b);",
       "tma_box(k_s + u * kSubBytes, k_map, bar(kKLanded + stage), 0, tile * kBk, h, b);")]),
    ("control: no edit", "layer_norm_wide", []),
    ("K11 D 4096: rows cut to 8 vectors a lane", "layer_norm_wide",
     [(LN, "default: return vecs <= kMaxVecs ? pick_mode<kMaxVecs>(mode) : nullptr;",
       "default: return vecs <= kMaxVecs ? pick_mode<8>(mode) : nullptr;")]),
    ("K11 D 4096: gamma dropped", "layer_norm_wide",
     [(LN, "          if (gamma != nullptr) {", "          if (false) {")]),
    ("K11 D 4096: statistics taken in bf16", "layer_norm_wide",
     [(LN, "const float mu = __fmul_rn(warp_sum(sum), inv_d);",
       "const float mu = round_bf16(__fmul_rn(warp_sum(sum), inv_d));"),
      (LN, "const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));",
       "const float rstd = round_bf16(rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps)));")]),
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
    ("K5 bin by reciprocal multiply", "bilateral",
     [(BL, "const int bin = (int)__fdiv_rn(v, p.sigma_luma);",
       "const int bin = (int)(v * (1.f / p.sigma_luma));")]),
    ("K5 a class's tail dropped", "bilateral",
     [(BL, "if (i < vol) ob[i] = slice_read(", "if (i < cl.head) ob[i] = slice_read(")]),
    ("K5 a class's head dropped", "bilateral",
     [(BL, "if (i < vol) ob[i] = slice_read(", "if (i < vol && i >= cl.head) ob[i] = slice_read(")]),
    ("K5 a run's lattice row one cell off in y", "bilateral",
     [(BL, "const uint32_t row = (p.by_ss.div(z) * p.NCY + p.by_ss.div(y)) * p.NCX;",
       "const uint32_t row = (p.by_ss.div(z) * p.NCY + max(p.by_ss.div(y), 1u) - 1) * p.NCX;")]),
    ("K5 classes b > 0 read class b / 2's lattice", "bilateral",
     [(BL, "const float* g = grid + (uint64_t)blockIdx.y * p.cells_L;",
       "const float* g = grid + (uint64_t)(blockIdx.y / 2) * p.cells_L;")]),
    ("K5 a run's last voxel placed at x + 2", "bilateral",
     [(BL, "row + p.by_ss.div(x + 3)", "row + p.by_ss.div(x + 2)")]),
    ("K7b a cell's first slot read from the cell before", "bilateral",
     [(RB, "const uint32_t cell = by_cell.div(i);",
       "const uint32_t cell = by_cell.div(i ? i - 1 : 0);")]),
    ("K7b bins below 0 read bin 0", "bilateral",
     [(RB, "return (unsigned)bin < L ? __ldg(g + cell * L + bin) : 0.f;",
       "return bin < (int)L ? __ldg(g + cell * L + max(bin, 0)) : 0.f;")]),
    ("K7b a class's tail dropped", "bilateral",
     [(RB, "if (i < per) ob[i] = blocked_slot(", "if (i < cl.head) ob[i] = blocked_slot(")]),
    ("K7b classes b > 0 read class b / 2's lattice", "bilateral",
     [(RB, "const float* g = yl + (uint64_t)blockIdx.y * cells_L;",
       "const float* g = yl + (uint64_t)(blockIdx.y / 2) * cells_L;")]),
    ("K8 l+1 neighbour read across an x boundary", "bilateral",
     [(BL, "const float lp = w.l + 4 < p.L ? __ldg(q + 4) : 0.f;",
       "const float lp = i + 4 < per ? __ldg(q + 4) : 0.f;")]),
    ("K8 a class's tail dropped", "bilateral",
     [(BL, "if (i < per) ob[i] = blur_one(", "if (i < cl.head) ob[i] = blur_one(")]),
    ("K8 a class's head dropped", "bilateral",
     [(BL, "if (i < per) ob[i] = blur_one(", "if (i < per && i >= cl.head) ob[i] = blur_one(")]),
    ("K8 z-1 boundary test off by one", "bilateral",
     [(BL, "const float4 zm = w.z > 0 ? ld4(q - p.sz) : zero;",
       "const float4 zm = w.z > 1 ? ld4(q - p.sz) : zero;")]),
    ("K8 a lone vertex's x+1 taken from x-1", "bilateral",
     [(BS, "w.x + 1 < p.X ? ld(i + p.L) : 0.f,", "w.x + 1 < p.X && w.x > 0 ? ld(i - p.L) : 0.f,")]),
    ("K8 z+1 and z-1 added in swapped order", "bilateral",
     [(BL, "o.x = sum9(p.center, c.x, zp.x, zm.x,", "o.x = sum9(p.center, c.x, zm.x, zp.x,")]),
    ("K6a a lane's source row one off in dy", "bilateral",
     [(RB, "const int z = z0 + it.row.dz, y = y0 + it.row.dy, xc = it.u * unit, xx = x0 + xc;",
       "const int z = z0 + it.row.dz, y = y0 + max(it.row.dy - 1, 0), xc = it.u * unit, "
       "xx = x0 + xc;")]),
    ("K6a and K6b: the last partial chunk dropped", "bilateral",
     [(RB, "const int64_t n_chunks = (Xp + c->W - 1) / c->W;",
       "const int64_t n_chunks = Xp / c->W;")]),
    ("K6a and K6b: a span's head word dropped", "bilateral",
     [(RB, "return t < 4 ? (t < head() ? t : n)", "return t < 4 ? (t + 1 < head() ? t : n)")]),
    ("K6a 16-byte reads from the row before", "bilateral",
     [(RB, "__ldg(reinterpret_cast<const uint4*>(xb + src))",
       "__ldg(reinterpret_cast<const uint4*>(xb + (src >= X ? src - X : src)))")]),
    ("K6b a chunk's tail words not read", "bilateral",
     [(RB, "if (k < ch.n) tile[lead + k] = __ldg(span + k);",
       "if (k < head + 4 * runs) tile[lead + k] = __ldg(span + k);")]),
    ("K6b a 16-byte write one row off", "bilateral",
     [(RB, "*reinterpret_cast<uint4*>(o) = make_uint4(",
       "*reinterpret_cast<uint4*>(o - (y > 0 ? X : 0)) = make_uint4(")]),
    ("K6b a run's first two x positions swapped", "bilateral",
     [(RB, "make_uint4(s[0], s[P], s[2 * P], s[3 * P])",
       "make_uint4(s[P], s[0], s[2 * P], s[3 * P])")]),
    ("K6b a cropped plane written over plane Z - 1", "bilateral",
     [(RB, "if (z >= Z || y >= Y || wx >= X) continue;", "if (y >= Y || wx >= X) continue;"),
      (RB, "uint32_t* o = ob + ((int64_t)z * Y + y) * X + wx;",
       "uint32_t* o = ob + ((int64_t)min(z, Z - 1) * Y + y) * X + wx;")]),
    ("K6b one word a lane read from lane p + 1", "bilateral",
     [(RB, "      *o = s[0];\n", "      *o = s[w.row.p + 1 < P ? 1 : 0];\n")]),
    ("control: no edit", "lattice_solve", []),
    ("K12 one CG step dropped", "lattice_solve",
     [(LS, "for (int step = 0; step < a.cg_maxiter; ++step) {",
       "for (int step = 1; step < a.cg_maxiter; ++step) {")]),
    ("K12 the per-class freeze removed", "lattice_solve",
     [(LS, "const bool active = rr > atol2;", "const bool active = rr > atol2 || true;")]),
    ("K12 a halo neighbour lost at a block boundary", "lattice_solve",
     [(LS, "    return __ldcg(u + i);\n", "    return 0.f;\n")]),
    ("control: no edit", "fused_block", []),
    # K3's attention launch: the wrapper around attention_core in fused_block.cu
    ("K3 attention: k rows read at pitch D instead of 3D", "fused_block",
     [(FB, "      ld, ld, ld, D, blockIdx.x", "      ld, D, ld, D, blockIdx.x")]),
    ("K3 attention: n_valid -> N (padded keys leak)", "fused_block",
     [(FB, "N, n_valid, 0.f, smem_attention);", "N, N, 0.f, smem_attention);")]),
    ("K3 attention: head offset 32 instead of 64", "fused_block",
     [(FB, "(int64_t)blockIdx.z * N * ld + blockIdx.y * attention_core::kHd;",
       "(int64_t)blockIdx.z * N * ld + blockIdx.y * 32;")]),
    ("K3 attention: v taken from the k third", "fused_block",
     [(FB, "      q, q + D, q + 2 * D, out", "      q, q + D, q + D, out")]),
    ("K3 attention: row max never taken", "fused_block",
     [(FB, "attention_core::attention_block<kMax, /*kPreScaled=*/true,",
       "attention_core::attention_block<false, /*kPreScaled=*/true,")]),
    ("K3 attention: row sum not held at 1e-38", "fused_block",
     [(FB, "/*kFloorSum=*/true>(", "/*kFloorSum=*/false>(")]),
    # the GEMM body under K3
    ("K3 gemm: last K chunk skipped (resident A)", "fused_block",
     [(GC, "      mma_chunk(acc, a_s + kc * kATileBytes", "      if (kc + 1 < n_k) mma_chunk(acc, a_s + kc * kATileBytes")]),
    ("K3 gemm: last K chunk skipped (ring: fc2)", "fused_block",
     [(GC, "    mma_chunk(acc, stage + wg * 64 * kChunkBytes",
       "    if (chunk + 1 < n_chunks) mma_chunk(acc, stage + wg * 64 * kChunkBytes")]),
    ("K3 gemm: LayerNorm gain dropped", "fused_block",
     [(FB, "    e[j] = __float2bfloat16(rbf(y * bf(ge[j])) + bf(be[j]));",
       "    e[j] = __float2bfloat16(y + bf(be[j]));")]),
    ("K3 gemm: LayerNorm rows staged one chunk to the right", "fused_block",
     [(FB, "wgmma_common::swz(r, c & 7));", "wgmma_common::swz(r, (c + 1) & 7));")]),
    # at D > 512 the LayerNorms are launches of K11's LN mode into the scratch
    ("K3 gemm: LayerNorm at D > 512 never read (rows streamed as they are)", "fused_block",
     [(FB, "    a.a = normed;\n", "")]),
    ("K3 gemm: LayerNorm eps 1e-2 at D > 512", "fused_block",
     [(FB, "a.K, 1e-6f, s))", "a.K, 1e-2f, s))")]),
    ("K3 gemm: residual from the attention buffer", "fused_block",
     [(FB, "{attn, wproj, bproj, nullptr, nullptr, ls1, x, x2, M, D, D}",
       "{attn, wproj, bproj, nullptr, nullptr, ls1, attn, x2, M, D, D}")]),
    ("K3 gemm: GELU dropped on even columns", "fused_block",
     [(FB, "pack_bf16(gelu_tanh(rbf(rbf(c0) + b.x)),", "pack_bf16(rbf(rbf(c0) + b.x),")]),
    ("K3 gemm: proj bias pointer is fc2's", "fused_block",
     [(FB, "{attn, wproj, bproj, nullptr", "{attn, wproj, bfc2, nullptr")]),
    ("K3 gemm: qkv bias dropped on even columns", "fused_block",
     [(FB, "pack_bf16(c0 + b.x, c1 + b.y);", "pack_bf16(c0, c1 + b.y);")]),
    ("K3 gemm: LayerScale dropped on even columns", "fused_block",
     [(FB, "xr.x + rbf(rbf(rbf(c0) + b.x) * ls.x),", "xr.x + rbf(rbf(c0) + b.x),")]),
    ("K3 gemm: every lane loads tile j0's bias", "fused_block",
     [(FB, "  load_words(bias, p.bias + n);", "  load_words(bias, p.bias + n0 + 8 * j0);")]),
    ("K3+K9 the quad transpose's last exchange crosses the wrong lanes", "fused_block",
     [(WC, "  r = __shfl_xor_sync(0xffffffffu, high ? w[1] : w[3], 2);",
       "  r = __shfl_xor_sync(0xffffffffu, high ? w[1] : w[3], 1);")]),
    ("control: no edit", "chain_gemm", []),
    # the GEMM body under K9 and K9's epilogues
    ("K9 gemm: last K chunk skipped", "chain_gemm",
     [(GC, "    mma_chunk(acc, stage + wg * 64 * kChunkBytes",
       "    if (chunk + 1 < n_chunks) mma_chunk(acc, stage + wg * 64 * kChunkBytes")]),
    ("K9 gemm: Wt rows read at a pitch one chunk short", "chain_gemm",
     [(CG, "p.wt + n0 * row_bytes, row_bytes, (int)(row_bytes / 128),",
       "p.wt + n0 * row_bytes, row_bytes - 128, (int)(row_bytes / 128),")]),
    ("K9 gemm: a block takes its left neighbour's W rows", "chain_gemm",
     [(CG, "p.wt + n0 * row_bytes, row_bytes, (int)(row_bytes / 128),",
       "p.wt + (n0 ? n0 - kBN : 0) * row_bytes, row_bytes, (int)(row_bytes / 128),")]),
    ("K9 gemm: MMA step 16 bytes of K instead of 32", "chain_gemm",
     [(GC, "tile_desc(a_tile + kk * 32), tile_desc(b_tile + kk * 32)",
       "tile_desc(a_tile + kk * 16), tile_desc(b_tile + kk * 16)")]),
    ("K9 requant: row max over all but the cluster's last block", "chain_gemm",
     [(CG, "for (uint32_t rank = 0; rank < n_blocks; ++rank)",
       "for (uint32_t rank = 0; rank < max(n_blocks - 1, 1u); ++rank)")]),
    ("K9 requant: roundf for rintf", "chain_gemm",
     [(CG, "q0 = (int)rintf(__fmul_rn((float)acc[j][2 * h], scale[h]));",
       "q0 = (int)roundf(__fmul_rn((float)acc[j][2 * h], scale[h]));")]),
    ("K9 requant: scale by reciprocal multiply", "chain_gemm",
     [(CG, "scale[h] = __fdiv_rn(127.0f, fmaxf((float)row_abs, 1e-6f));",
       "scale[h] = __fmul_rn(127.0f, __frcp_rn(fmaxf((float)row_abs, 1e-6f)));")]),
    ("K9 shift: by 7 bits", "chain_gemm",
     [(CG, "q0 = acc[j][2 * h] >> 8,", "q0 = acc[j][2 * h] >> 7,")]),
    ("K9 ping-pong: even steps always into tmp", "chain_gemm",
     [(CG, "return ((p.chain - 1 - step) & 1) ? p.tmp : p.out;",
       "return (step & 1) ? p.out : p.tmp;")]),
    ("K9 no cluster barrier between steps (a race)", "chain_gemm",
     [(CG, "if (step + 1 < p.chain || MODE == kModeRequant) cluster_sync();",
       "if (MODE == kModeRequant) cluster_sync();")]),
    ("K9 int8 tiles stored in swapped halves", "chain_gemm",
     [(CG, "make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),",
       "make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x5410),")]),
]

# K1 at (8, 6, 4097, 64) bf16 and its RoPE mode at the ViT-7B/16 cell's (32,
# 32, 1029, 128), with one part taken out or done another way: what the part
# costs (the results are wrong where a part is out: only the times count)
ATTENTION_ABLATION = [
    ("whole kernel", []),
    ("no exp2 (p = x)", [(AC, '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                          "  y = x;")]),
    ("no K/V copies after the first tiles",
     [(AC, "    load_kv(tile + kStages - 1);  // into the slot tile - 1 used",
       "    cp_async_commit();")]),
    ("no p.v product",
     [(AC, "        wgmma_rs<true>(acc[u], pf[kk], tile_desc(v_s + u * kSubBytes + kk * 2048), 1);",
       "        ;")]),
    ("no row sums on the tensor cores",
     [(AC, "      wgmma_rs_n8(lsum, pf[kk], tile_desc(ones_s));", "      lsum[0] = lsum[2] = 1.f;")]),
    ("no scores product after tile 0",
     [(AC, "    issue_scores(tile + 1);\n", "    wgmma_fence();\n    wgmma_commit();\n")]),
    ("no softmax in the loop",
     [(AC, "    softmax_step<kMax, kPreScaled>(s, m, alpha, pf, scale_log2);\n    if (kMax && __any",
       "    alpha[0] = alpha[1] = 1.f;\n    if (kMax && __any")]),
    ("whole kernel, again", []),
    ("RoPE mode: whole kernel", []),
    ("RoPE mode: no rotation (the producer hands tiles on as they land)",
     [(RA, "        for (int i = r; i < rows * 8; i += kRotators)",
       "        for (int i = r; i < 0; i += kRotators)")]),
    ("RoPE mode: consumers in lock step (one barrier for both, no turns)",
     [(RA, "{ bar_sync(kTurnBar + wg, 256); }", "{ bar_sync(kTurnBar, 256); }"),
      (RA, "{ bar_arrive(kTurnBar + (wg ^ 1), 256); }", "{}")]),
    ("RoPE mode: 3 ring slots", [(RA, "constexpr int kStages = 4; ", "constexpr int kStages = 3; ")]),
    ("RoPE mode: 5 ring slots", [(RA, "constexpr int kStages = 4; ", "constexpr int kStages = 5; ")]),
    ("RoPE mode: whole kernel, again", []),
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


# K3's five launches and K9's three modes at the main path's shapes with one
# part of the GEMM body taken out (the results are wrong, only the times count)
GEMM_ABLATION = [
    ("whole kernels", []),
    ("no copies after the first chunks",
     [(GC, "      load(step + kAhead);\n", "      cp_async_commit();\n"),
      (GC, "    load(chunk + kAhead);  // into the slot chunk - 2 used\n", "    cp_async_commit();\n")]),
    ("no MMAs", [(GC, "    wgmma_ss(acc, tile_desc(a_tile + kk * 32), tile_desc(b_tile + kk * 32), "
                      "!(first && kk == 0));\n", "    ;\n")]),
    ("no epilogue stores in K3 (no bias, GELU, residual either)",
     [(FB, "    const bool stored = m[h] < p.M;\n",
       "    const bool stored = m[h] < p.M && acc[j0][0] == 12345.f;\n")]),
    ("no LayerNorm arithmetic (rows staged as they are)",
     [(FB, "*vec[i] = layer_norm8(v[i], mu, rs, p.ln_w + (l16 + 16 * i) * 8, p.ln_b + (l16 + 16 * i) * 8);",
       "*vec[i] = v[i];")]),
    ("whole kernels, again", []),
]


# K8 at the request's, the whole grid's and the 2-D solver's lattices, and
# K6a and K6b at the request's planes, with one part taken out or one size changed
# (results wrong where a part is out: only the times count)
BILATERAL_ABLATION = [
    ("whole kernels", []),
    ("K8 two runs a thread", [(BL, "constexpr int kBlurRuns = 1;", "constexpr int kBlurRuns = 2;")]),
    ("K8 no z neighbour loads",
     [(BL, "const float4 zp = w.z + 1 < p.Z ? ld4(q + p.sz) : zero;", "const float4 zp = zero;"),
      (BL, "const float4 zm = w.z > 0 ? ld4(q - p.sz) : zero;", "const float4 zm = zero;")]),
    ("K8 no y neighbour loads",
     [(BL, "const float4 yp = w.y + 1 < p.Y ? ld4(q + p.sy) : zero;", "const float4 yp = zero;"),
      (BL, "const float4 ym = w.y > 0 ? ld4(q - p.sy) : zero;", "const float4 ym = zero;")]),
    ("K8 no x neighbour loads",
     [(BL, "const float4 xp = w.x + 1 < p.X ? ld4(q + p.L) : zero;", "const float4 xp = zero;"),
      (BL, "const float4 xm = w.x > 0 ? ld4(q - p.L) : zero;", "const float4 xm = zero;")]),
    ("K6a and K6b chunks of at most 128 x positions (two a slab row at 128^3)",
     [(RB, "constexpr int kReblockWidth = 136;", "constexpr int kReblockWidth = 128;")]),
    ("K6a and K6b chunks of at most 64 x positions",
     [(RB, "constexpr int kReblockWidth = 136;", "constexpr int kReblockWidth = 64;")]),
    ("K6b streaming loads (__ldcs) instead of __ldg",
     [(RB, "= __ldg(reinterpret_cast<const uint4*>(span + k));",
       "= __ldcs(reinterpret_cast<const uint4*>(span + k));"),
      (RB, "tile[lead + k] = __ldg(span + k);", "tile[lead + k] = __ldcs(span + k);")]),
    ("K6a and K6b chunks a multiple of 8 x positions (32-byte row pieces)",
     [(RB, "c->W = (int)(((Xp + pieces - 1) / pieces + 3) & ~3);",
       "c->W = (int)(((Xp + pieces - 1) / pieces + 7) & ~7);")]),
    ("K6b reads not unrolled",
     [(RB, "read again\n#pragma unroll 4\n  for (int r = threadIdx.x;",
       "read again\n  for (int r = threadIdx.x;")]),
    ("K6b tile reads rotated by lane group (no bank conflicts at odd ss)",
     [(RB, "*reinterpret_cast<uint4*>(o) = make_uint4(s[0], s[P], s[2 * P], s[3 * P]);",
       "{ const int q = (w.u >> 3) & 3;"
       " const uint32_t a0 = s[q * P], a1 = s[((q + 1) & 3) * P], a2 = s[((q + 2) & 3) * P],"
       " a3 = s[((q + 3) & 3) * P];"
       " *reinterpret_cast<uint4*>(o) = q == 0 ? make_uint4(a0, a1, a2, a3)"
       " : q == 1 ? make_uint4(a3, a0, a1, a2) : q == 2 ? make_uint4(a2, a3, a0, a1)"
       " : make_uint4(a1, a2, a3, a0); }")]),
    ("K6b streaming stores",
     [(RB, "*reinterpret_cast<uint4*>(o) = make_uint4(s[0], s[P], s[2 * P], s[3 * P]);",
       "__stcs(reinterpret_cast<uint4*>(o), make_uint4(s[0], s[P], s[2 * P], s[3 * P]));")]),
    ("whole kernels, again", []),
]


# K12 at the refined edit cell's and the 2-D solver's lattices (both resident)
# with one part taken out or done another way (results wrong where a part is
# out: only the times count)
LATTICE_SOLVE_ABLATION = [
    ("whole kernel", []),
    ("barrier by fences around a relaxed add (cooperative groups' grid sync)",
     [(LS, '    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : '
           '"memory");\n', "    __threadfence();\n    atomicAdd(count, 1u);\n"),
      (LS, '"l"(count) : "memory");\n  }\n', '"l"(count) : "memory");\n    __threadfence();\n  }\n')]),
    ("halo through L1 (plain loads)", [(LS, "    return __ldcg(u + i);\n", "    return u[i];\n")]),
    ("no halo reads (a block's own copy only)",
     [(LS, "    return __ldcg(u + i);\n", "    return own[0];\n")]),
    ("no grid barrier (blocks never wait for each other)",
     [(LS, "  if (threadIdx.x == 0) {\n    asm volatile(\"red.release",
       "  if (false) {\n    asm volatile(\"red.release")]),
    ("whole kernel, again", []),
]


def _time_lattice_solve(cs, torch):
    out = []
    for name, crop, ss, sl, dim in (("cell", cs.K12_CELL_CROP, cs.BLS_SS, cs.BLS_SL, 6),
                                    ("2-D", (2048, 2048), cs.BLS2D_SS, cs.BLS2D_SL, 5)):
        _, m, w, b, ext = cs.lattice_case(0, crop, 1, ss, sl)
        kw = dict(lam=256.0, A_diag_min=1e-5, cg_tol=1e-5, cg_maxiter=25, bistoch_iters=10,
                  blur_dim=dim)
        solve = [round(cs.ten_call_ms(lambda: cs.lattice_solve(m, w, b, ext, **kw)), 5)
                 for _ in range(3)]
        setup = cs.ten_call_ms(lambda: cs.lattice_solve(
            m, w, b, ext, **{**kw, "cg_maxiter": 0, "bistoch_iters": 0}))
        out.append(f"K12 {name} {solve}, without its 10 + 25 steps {round(setup, 5)}")
    return "ms: " + ", ".join(out)


def _time_bilateral(cs, torch):
    gen = torch.Generator().manual_seed(0)
    ss, sl = cs.BLS_SS, cs.BLS_SL
    chunk = 70_000_000 // 256**3
    lats = {name: (torch.randn((c,) + cs._grid_extents(shape, s, l), generator=gen).to("cuda"), d)
            for name, c, shape, s, l, d in (
                ("request", cs.BLS_C, (128,) * 3, ss, sl, 6),
                ("whole grid", chunk, (256,) * 3, ss, sl, 6),
                ("2-D", 1, (2048, 2048), cs.BLS2D_SS, cs.BLS2D_SL, 5))}
    out = [f"K8 {name} {round(cs.ten_call_ms(lambda: cs.bls_blur(lat, d)), 5)}"
           for name, (lat, d) in lats.items()]
    c = torch.rand((cs.BLS_C,) + (128,) * 3, generator=gen).to("cuda")
    c_b = cs.bls_reblock(c, ss)
    out.append(f"K6a {round(cs.ten_call_ms(lambda: cs.bls_reblock(c, ss)), 5)}")
    out.append(f"K6b {round(cs.ten_call_ms(lambda: cs.bls_unreblock(c_b, ss, c.shape[1:])), 5)}")
    return "ms: " + ", ".join(out)


def _time_gemms(cs, torch):
    gen = torch.Generator().manual_seed(0)
    cfg = cs.resolve_model("vits8")
    model = cs.VisionTransformer.from_state_dict(cfg, cs.init_vit_params(cfg, (0, 0)))
    blk = model.to("cuda", torch.bfloat16).blocks[0]
    x = (0.5 * torch.randn(cs.BLOCK_SHAPE, generator=gen)).to("cuda", torch.bfloat16)
    each = cs.fused_launch_ms(x, blk, cfg.num_heads, False)
    block = cs.cuda_ms(lambda: cs.fused_block(x, blk, cfg.num_heads, softmax_max=False))
    inputs = cs.bench_int8_gemm.make_inputs(cs.K9_ROWS, cs.K9_DIM, "cuda")
    k9 = {m: round(cs.cuda_ms(lambda: cs.chain_gemm(*inputs[m], cs.K9_CHAIN, m)), 4)
          for m in cs.CHAIN_MODES}
    return (f"K3 block {round(block, 4)} ms, launches "
            f"{dict(zip(cs.K3_LAUNCHES, (round(t, 4) for t in each)))}; K9 chain {cs.K9_CHAIN} {k9}")


def _time_attention(cs, torch):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(cs.ATTN_SHAPE, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    ours = [round(cs.cuda_ms(lambda: cs.attention(q, k, v), reps=21), 4) for _ in range(3)]
    lib = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), reps=21)
    qr, kr, vr, rope = cs.rope_case(cs.ROPE_SHAPE, cs.ROPE_GRID, gen)
    rope_ms = [round(cs.ten_call_ms(lambda: cs.attention(qr, kr, vr, rope)), 4) for _ in range(3)]
    return (f"kernel {ours} ms, scaled_dot_product_attention {round(lib, 4)} ms; "
            f"RoPE mode {rope_ms} ms")


def _time_similarity(cs, torch):
    gen = torch.Generator().manual_seed(0)
    feats, queries, m = cs.similarity_case(gen, cs.SIM_N, [cs.SIM_PER_CLASS] * cs.SIM_C)
    out = []
    for mean_first in (False, True):
        ms = cs.cuda_ms(lambda: cs.similarity(feats, queries, m, mean_first=mean_first))
        out.append(f"mean_first={mean_first} {round(ms, 3)} ms")
    return ", ".join(out)


def _stale_replay(self, *args):
    """``Graph.__call__`` without the copy of the inputs in."""
    self.graph.replay()
    return self.output.clone()


def _stale_starts(self, *args):
    """``Graph.__call__`` copying in every input but the last, a refine
    core's starts."""
    for buf, x in zip(self.inputs[:-1], args[:-1]):
        buf.copy_(x)
    self.graph.replay()
    return self.output.clone()


def _baked_starts(refine):
    """``refine._refine_core`` whose body crops at the host starts of the
    call it is captured on (Python slices of ``_refine_batched_core``), the
    starts input left unread."""
    from unittest import mock

    def body(sims, vol_u8, _starts, crop_shape, solve_kw, starts):
        with mock.patch.object(refine, "bilateral_solve_gray_batched",
                               refine._bilateral_solve_eager):
            return refine._refine_batched_core(sims, vol_u8, starts, crop_shape, solve_kw)

    def core(sims, vol_u8, starts, crop_shape, solve_kw):
        key = refine._core_key(sims.device, sims.shape, crop_shape, solve_kw)
        return refine.cuda_graphs.graphed(
            key, (sims, vol_u8, starts),
            functools.partial(body, crop_shape=crop_shape, solve_kw=solve_kw,
                              starts=starts.cpu().numpy()), refine._WRAPPERS)
    return core


def _owner(path):
    """The module ``vittf_tpu_torch.<path>``, or a name in it (``mod:Name``)."""
    import importlib

    module, _, name = path.partition(":")
    mod = importlib.import_module("vittf_tpu_torch." + module)
    return getattr(mod, name) if name else mod


# (name, owner of the patched name, name, its value given the owner's module):
# faults of the graph routes that ``_check_graphs`` must catch
GRAPH_FAULTS = [
    ("graph replayed without copying the inputs in", "utils.cuda_graphs:Graph", "__call__",
     lambda m: _stale_replay),
    ("graph key without cg_tol", "ops.bilateral", "_STATIC_ARGS",
     lambda m: tuple(a for a in m._STATIC_ARGS if a != "cg_tol")),
    ("graph key without the form", "ops.bilateral", "_graph_key",
     lambda m: lambda device, shape, kw: (device.index, tuple(shape))
     + tuple({**m._SOLVE_DEFAULTS, **kw}[a] for a in m._STATIC_ARGS)),
    ("refine core with the starts baked in as host constants", "pipeline.refine", "_refine_core",
     _baked_starts),
    ("refine core key without crop_shape", "pipeline.refine", "_core_key",
     lambda m: lambda device, shape, crop_shape, solve_kw: ("refine core", tuple(shape[1:]))
     + m._graph_key(device, tuple(shape), solve_kw)),
    ("replay without copying the starts in", "utils.cuda_graphs:Graph", "__call__",
     lambda m: _stale_starts),
]


def _check_graphs(cs, torch):
    """The refine core witness (``chip_smoke.phase_core_witness``: two crop
    shapes, four starts each), then five graphed solves of five 48 x 40 x 56
    crops, every call held against its witness (``chip_smoke.
    witness_fresh``): a solve key's eager first sighting, its capture and a
    replay on other inputs, then those inputs at another ``cg_tol`` and in
    the split form, each its own key."""
    from vittf_tpu_torch.ops import bilateral

    cores = cs.phase_core_witness(0)

    gen = torch.Generator().manual_seed(0)
    shape = (cs.BLS_C, 48, 40, 56)

    def planes():
        lu = torch.randint(0, 256, shape, generator=gen).float()
        return [x.to("cuda") for x in (torch.rand(shape, generator=gen), lu,
                                       torch.rand(shape, generator=gen))]

    a, b, c = planes(), planes(), planes()
    kw = dict(sigma_spatial=cs.BLS_SS, sigma_luma=cs.BLS_SL)
    held = cs.witness_fresh("graph check", *(
        functools.partial(bilateral.bilateral_solve_gray_batched, *x, **k)
        for x, k in ((a, kw), (b, kw), (c, kw), (b, {**kw, "cg_tol": 0.1}),
                     (c, {**kw, "pixel_impl": "reblock"}))))
    return f"refine cores held {cores}, solves held {held}"


def run_graph_faults(cs, torch) -> list:
    """The control, then each of ``GRAPH_FAULTS`` patched in for one
    ``_check_graphs``; returns whether each fault passed."""
    from unittest import mock

    verdicts = []
    for name, owner, attr, value in [("control: no patch", None, None, None)] + GRAPH_FAULTS:
        target = owner and _owner(owner)
        patch = (mock.patch.object(target, attr, value(_owner(owner.partition(":")[0])))
                 if owner else contextlib.nullcontext())
        try:
            with patch:
                out = _check_graphs(cs, torch)
            print(f"PASSED {name}: {out}")
            passed = True
        except (AssertionError, RuntimeError) as e:
            print(f"FAILED {name}: {str(e)[:300]}")
            passed = False
        if owner:
            verdicts.append(passed)
    cs.GRAPHS.clear()
    return verdicts


class EditDoesNotApply(ValueError):
    pass


@contextlib.contextmanager
def edited_library(edits, kernels):
    """The kernel library built from a copy of the sources with ``edits``
    applied, loaded for the ``with`` block; the sources' own library after
    it. Raises ``EditDoesNotApply`` before any build where an ``old`` string
    does not occur exactly once."""
    orig = kernels.CSRC
    tmp = Path(tempfile.mkdtemp(prefix="vittf_variant_"))
    try:
        shutil.copytree(orig, tmp / "csrc")
        for fname, old, new in edits:
            path = tmp / "csrc" / fname
            text = path.read_text()
            if text.count(old) != 1:
                raise EditDoesNotApply(f"{old!r} occurs {text.count(old)} times in {fname}")
            path.write_text(text.replace(old, new))
        kernels.CSRC, kernels._lib = tmp / "csrc", None
        yield kernels.load_library()
    finally:
        kernels.CSRC, kernels._lib = orig, None
        shutil.rmtree(tmp, ignore_errors=True)


def run_variant(name, edits, check, kernels) -> bool | None:
    """Build ``edits`` into a copy of the sources and run ``check`` with the
    copy's library loaded; prints the verdict, returns whether it passed
    (None: an edit did not apply and nothing ran)."""
    import torch

    try:
        with edited_library(edits, kernels):
            try:
                out = check()
                print(f"PASSED {name}: {out if isinstance(out, str) else ''}")
                return True
            except (AssertionError, RuntimeError) as e:
                print(f"FAILED {name}: {str(e)[:300]}")
                return False
            finally:
                torch.cuda.synchronize()
    except EditDoesNotApply as e:
        print(f"EDIT DOES NOT APPLY {name}: {e}")
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["faults", "attention-ablation", "similarity-ablation",
                                     "gemm-ablation", "bilateral-ablation",
                                     "lattice-solve-ablation", "graph-faults"])
    ap.add_argument("--only", default="",
                    help="run the variants whose name starts with one of these (comma-separated)")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(","))

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
    if args.what == "graph-faults":
        verdicts = run_graph_faults(cs, torch)
        print(f"planted graph faults: {verdicts.count(False)} caught, "
              f"{verdicts.count(True)} not caught")
        return 0
    if args.what == "faults":
        # a control (no edit) runs when a selected fault shares its phase
        phases = {phase for name, phase, edits in FAULTS if edits and name.startswith(only)}
        todo = [(name, edits, lambda p=phase: getattr(cs, "phase_" + p)(
            torch.Generator().manual_seed(0))) for name, phase, edits in FAULTS if phase in phases]
    elif args.what == "attention-ablation":
        todo = [(n, e, lambda: _time_attention(cs, torch)) for n, e in ATTENTION_ABLATION]
    elif args.what == "similarity-ablation":
        todo = [(n, e, lambda: _time_similarity(cs, torch)) for n, e in SIMILARITY_ABLATION]
    elif args.what == "gemm-ablation":
        todo = [(n, e, lambda: _time_gemms(cs, torch)) for n, e in GEMM_ABLATION]
    elif args.what == "lattice-solve-ablation":
        todo = [(n, e, lambda: _time_lattice_solve(cs, torch)) for n, e in LATTICE_SOLVE_ABLATION]
    else:
        todo = [(n, e, lambda: _time_bilateral(cs, torch)) for n, e in BILATERAL_ABLATION]
    verdicts = []
    for name, edits, check in todo:
        if not name.startswith(only) and not name.startswith("control"):
            continue
        passed = run_variant(name, edits, check, kernels)
        if edits and args.what == "faults":
            verdicts.append(passed)
    if args.what == "faults":
        print(f"planted faults: {verdicts.count(False)} caught, {verdicts.count(True)} not caught, "
              f"{verdicts.count(None)} edits did not apply")
    return 0


if __name__ == "__main__":
    sys.exit(main())
