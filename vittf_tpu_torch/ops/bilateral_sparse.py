"""General (RGB-capable) sparse bilateral solver: native grid + device CG.

Port of ``vittf_tpu/ops/bilateral_sparse.py``. The dense path
(ops.bilateral) covers the grayscale references this pipeline produces; for
true RGB references the 6-D bilateral lattice is too large to densify. Here
the data-dependent part — hashing pixels to unique vertices and resolving
the ±1 blur neighbors — runs in the native C++ library
(``vittf_tpu_torch.native.bilateral_grid_build``), and the solve runs on
the device:

- splat  = ``index_add_`` over vertex ids
- blur   = 2·dim·x + Σ_{d,±} gathered neighbor values (−1 → 0)
- solve  = the bistochastized Jacobi-PCG of the dense path
  (``ops.bilateral._lattice_solve`` with this blur as its operator)

No hand-written kernel lies on this path in the JAX package either. Its
power-of-two vertex bucket exists to keep jit caches warm; padded vertices
are unoccupied identity rows with a zero right-hand side, so no value
depends on them and eager PyTorch has no cache to keep: it is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch.native import bilateral_grid_build
from vittf_tpu_torch.ops.bilateral import (
    BS_PARAMS_DEFAULT,
    GRID_PARAMS_DEFAULT,
    _lattice_solve,
)

# reference bilateral_solver3d.py:11-15
RGB_TO_YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]]
)
YUV_OFFSET = np.array([0.0, 128.0, 128.0])


def rgb2yuv(im: np.ndarray) -> np.ndarray:
    """(..., 3) RGB → YUV with the reference's matrix/offset."""
    return np.tensordot(im, RGB_TO_YUV, ([-1], [1])) + YUV_OFFSET


def build_grid(
    reference_rgb: np.ndarray,
    sigma_spatial: int,
    sigma_luma: int,
    sigma_chroma: int,
):
    """(W, H, D, 3) RGB uint8 → (vertex_of_pixel, neighbors, nverts).

    Coordinate construction per reference bilateral_solver3d.py:39-48:
    3 spatial + luma + 2 chroma, integer-truncated after σ division.
    """
    W, H, D = reference_rgb.shape[:3]
    yuv = rgb2yuv(reference_rgb.astype(np.float64))
    gz, gy, gx = np.mgrid[:W, :H, :D]
    coords = np.concatenate(
        [
            (gx / sigma_spatial).astype(np.int32)[..., None],
            (gy / sigma_spatial).astype(np.int32)[..., None],
            (gz / sigma_spatial).astype(np.int32)[..., None],
            (yuv[..., [0]] / sigma_luma).astype(np.int32),
            (yuv[..., 1:] / sigma_chroma).astype(np.int32),
        ],
        axis=-1,
    ).reshape(-1, 6)
    return bilateral_grid_build(coords)


def _solve_sparse(
    t, c, vid, neighbors,
    dim: int, lam: float, A_diag_min: float, cg_tol: float, cg_maxiter: int,
    bistoch_iters: int = 10,
):
    """t/c: (npix,) fp32; vid: (npix,) int64; neighbors: (nverts, dim, 2)."""
    nverts = neighbors.shape[0]
    nb = neighbors.reshape(nverts, 2 * dim).long()
    present, nb = nb >= 0, nb.clamp_min(0)

    def splat(x):
        return torch.zeros(nverts, dtype=torch.float32, device=x.device).index_add_(0, vid, x)

    def blur(x, _dim):  # (1, nverts), the operator _lattice_solve calls
        out = 2.0 * dim * x
        for j in range(2 * dim):
            out = out + torch.where(present[:, j], x[0, nb[:, j]], 0.0)
        return out

    m, w_splat, b = splat(torch.ones_like(t)), splat(c), splat(t * c)
    yhat = _lattice_solve(
        m[None], w_splat[None], b[None], (nverts,), lam, A_diag_min, cg_tol, cg_maxiter,
        bistoch_iters, dim, blur=blur,
    )[0]
    return torch.nan_to_num(yhat[vid])


def apply_bilateral_solver3d_rgb(
    t: torch.Tensor,
    r,
    c: torch.Tensor | None = None,
    grid_params: dict | None = None,
    bs_params: dict | None = None,
) -> torch.Tensor:
    """Reference-signature solver for true RGB references; runs on ``t``'s
    device (the grid is hashed on the host).

    Args:
        t: target (1, W, H, D) or (W, H, D) float in [0, 1]
        r: reference (3, W, H, D) uint8 RGB (array or tensor)
        c: optional confidence; defaults to inverted Sobel of r[0]/255
           (reference :229-238)
    """
    from vittf_tpu_torch.ops.morphology import filter_sobel_separated
    from vittf_tpu_torch.utils.tensor import make_5d

    gp = {**GRID_PARAMS_DEFAULT, **(grid_params or {})}
    bs = {**BS_PARAMS_DEFAULT, **(bs_params or {})}
    shape = tuple(t.shape[-3:])
    t = t.reshape(shape).float()
    r = r.cpu().numpy() if torch.is_tensor(r) else np.asarray(r)
    if c is None:
        r0 = torch.from_numpy(np.ascontiguousarray(r[0])).to(t.device).float() / 255.0
        sob = filter_sobel_separated(make_5d(r0)).reshape(shape)
        c = sob.max() - sob
    else:
        c = torch.as_tensor(c).to(t.device).reshape(shape).float()

    rgb = np.moveaxis(r, 0, -1)  # (W, H, D, 3)
    vid, neighbors, _ = build_grid(
        rgb, int(gp["sigma_spatial"]), int(gp["sigma_luma"]), int(gp["sigma_chroma"])
    )
    out = _solve_sparse(
        t.reshape(-1), c.reshape(-1),
        torch.from_numpy(vid).to(t.device).long(), torch.from_numpy(neighbors).to(t.device),
        6, float(bs["lam"]), float(bs["A_diag_min"]),
        float(bs["cg_tol"]), int(bs["cg_maxiter"]),
    )
    return out.reshape(shape)
