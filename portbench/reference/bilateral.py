"""A frozen plain 3-D bilateral solver for grayscale references.

The fast bilateral solver (Barron & Poole 2016) on a dense lattice of
(z, y, x, luma) vertices, as the reference pipeline's
bilateral_solver3d.py:37-154 computes it for a gray volume, in plain torch
scatter / gather operations:

- splat: per (spatial cell, luma bin) the voxel count, Σc and Σt·c, with
  cell = voxel // σ_spatial and bin = int(luma / σ_luma);
- blur: 2·dim·y plus the ±1 neighbours along every lattice axis, zero
  boundaries (dim = 6: the reference hashes 6-D coordinates);
- bistochastization (10 steps), then Jacobi-preconditioned CG on
  A(y) = λ(Dm − Dn·blur·Dn)y + diag(splat(c))·y, the identity on empty
  vertices; a problem stops once ⟨r, r⟩ ≤ tol²·⟨b, b⟩;
- slice: each voxel reads its vertex.
"""
from __future__ import annotations

import torch

BLUR_DIM = 6


def _grid_extents(shape, sigma_spatial, sigma_luma):
    return tuple((s - 1) // sigma_spatial + 1 for s in shape) + (int(255.0 / sigma_luma) + 1,)


def _vertex_ids(shape, luma, sigma_spatial, sigma_luma):
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    vid = torch.zeros((), dtype=torch.int64, device=luma.device)
    for ax, s in enumerate(shape):
        idx = torch.arange(s, device=luma.device) // sigma_spatial
        vid = vid * ext[ax] + idx.reshape((s,) + (1,) * (len(shape) - ax - 1))
    # true division by a tensor: a scalar divisor may become a reciprocal multiply
    sl = torch.full((), float(sigma_luma), device=luma.device)
    return vid * ext[-1] + (luma.float() / sl).to(torch.int64), ext


def _blur(y: torch.Tensor) -> torch.Tensor:
    out = (2.0 * BLUR_DIM) * y
    for ax in range(1, y.ndim):
        pad = [0, 0] * (y.ndim - 1 - ax) + [1, 1]
        yp = torch.nn.functional.pad(y, pad)
        n = y.shape[ax]
        out = out + yp.narrow(ax, 2, n) + yp.narrow(ax, 0, n)
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def solve(target, luma, confidence, sigma_spatial=7, sigma_luma=5, lam=256.0,
          A_diag_min=1e-5, cg_tol=1e-5, cg_maxiter=25, bistoch_iters=10,
          bf16_lattice: bool = False) -> torch.Tensor:
    """(B, *shape) target, luma in [0, 255] and confidence → (B, *shape) fp32.
    ``bf16_lattice`` (the control) rounds every lattice vector to bf16 where
    it is made: the splats, each blur and the CG's iterates."""
    rnd = _bf16 if bf16_lattice else (lambda t: t)
    B, shape = target.shape[0], tuple(target.shape[1:])
    vid, ext = _vertex_ids(shape, luma, sigma_spatial, sigma_luma)
    nv = 1
    for e in ext:
        nv *= e
    flat = (vid + torch.arange(B, device=luma.device).reshape((B,) + (1,) * len(shape)) * nv
            ).reshape(-1)
    c, t = confidence.float().reshape(-1), target.float().reshape(-1)

    def splat(v):
        return rnd(torch.zeros(B * nv, device=luma.device).index_add_(0, flat, v).reshape(B, nv))

    m, w, b = splat(torch.ones_like(c)), splat(c), splat(t * c)

    def blur(y):
        return rnd(_blur(y.reshape((B,) + ext)).reshape(B, nv))

    def dot(u, v):
        return (u * v).sum(dim=1)

    occupied = m > 0
    n = occupied.float()
    for _ in range(bistoch_iters):
        bn = blur(n)
        n = torch.where(occupied, torch.sqrt(n * m / torch.where(bn > 0, bn, 1.0)), 0.0)
    m_b = n * blur(n)

    def A(y):
        return torch.where(occupied, lam * (m_b * y - n * blur(n * y)) + w * y, y)

    a_diag = torch.where(occupied, torch.clamp(lam * (m_b - 2.0 * BLUR_DIM * n * n) + w,
                                               min=A_diag_min), 1.0)
    atol2 = torch.clamp(cg_tol ** 2 * dot(b, b), min=0.0)
    x = torch.where(w > 0, b / torch.where(w > 0, w, 1.0), 0.0)
    r = b - A(x)
    p = z = r / a_diag
    gamma = dot(r, z)
    for _ in range(cg_maxiter):
        active = dot(r, r) > atol2
        Ap = A(p)
        alpha = (gamma / dot(p, Ap))[:, None]
        x_new, r_new = x + alpha * p, r - alpha * Ap
        z = r_new / a_diag
        gamma_new = dot(r_new, z)
        p_new = z + (gamma_new / gamma)[:, None] * p
        keep = active[:, None]
        x, r, p = (rnd(torch.where(keep, new, old)) for new, old in
                   ((x_new, x), (r_new, r), (p_new, p)))
        gamma = torch.where(active, gamma_new, gamma)
    out = torch.gather(x, 1, vid.reshape(B, -1))
    return torch.nan_to_num(out.reshape((B,) + shape))
