"""3D fast bilateral solver on a dense lattice, for grayscale references.

Port of ``vittf_tpu/ops/bilateral.py``. For the grayscale references this
pipeline feeds, the bilateral vertices live in a dense 4-D lattice
(z, y, x, luma) of static extent (the constant chroma axes add nothing but
the central blur factor 2·6):

- splat = per (spatial cell, luma bin): voxel count, Σc and Σt·c;
- blur  = 2·dim·y plus the ±1 neighbours along every lattice axis, zero
  boundaries (empty vertices hold 0 and so contribute nothing);
- slice = per voxel, the solved value of its vertex;
- solve = bistochastization, then Jacobi-preconditioned CG on
  A(y) = λ(Dm − Dn·blur·Dn)y + diag(splat(c))·y, the identity on empty
  vertices (reference bilateral_solver3d.py:37-154).

Every function takes a leading batch (class) axis, which the JAX twin gets
from ``vmap``. Each lattice operator has a hand-written CUDA kernel in
``csrc/bilateral.cu`` and a plain PyTorch twin beside it. ``bls_splat``,
``bls_slice`` and ``bls_blur`` launch the kernel for CUDA tensors and run the
twin for CPU tensors; ``pixel_impl='scatter'`` runs the twins on any device.
The TPU lowerings ``'scan'``, ``'pallas_reblock'`` and ``'pallas_interpret'``
are not ported, nor is the coarse-to-fine solve.
"""
from __future__ import annotations

import numpy as np
import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.ops.morphology import filter_sobel_separated
from vittf_tpu_torch.utils.tensor import make_5d

GRID_PARAMS_DEFAULT = {  # reference bilateral_solver3d.py:156-160
    "sigma_luma": 4,
    "sigma_chroma": 4,
    "sigma_spatial": 24,
}
BS_PARAMS_DEFAULT = {  # reference bilateral_solver3d.py:162-167
    "lam": 256,
    "A_diag_min": 1e-5,
    "cg_tol": 1e-5,
    "cg_maxiter": 25,
}
_BLUR_DIM = 6  # the 3D reference hashes 6-D coords; central factor is 2·dim
_BLUR_DIM_2D = 5  # 2D reference: (x, y, luma, u, v)


def _grid_extents(shape, sigma_spatial, sigma_luma):
    spatial = tuple(int((s - 1) // sigma_spatial) + 1 for s in shape)
    luma = int(255.0 / sigma_luma) + 1
    return spatial + (luma,)


def _luma_bins(luma: torch.Tensor, sigma_luma) -> torch.Tensor:
    """int(luma / σ_l) per voxel, truncated toward zero. The divisor is a
    tensor on luma's device: PyTorch divides a CUDA tensor by a Python scalar
    as a multiply by its reciprocal, which can move a knife-edge voxel into
    the neighbouring bin. The kernels divide too."""
    sl = torch.tensor(float(sigma_luma), dtype=torch.float32, device=luma.device)
    return (luma.float() / sl).to(torch.int64)


def _vertex_ids(shape, luma: torch.Tensor, sigma_spatial, sigma_luma):
    """Flat dense-lattice vertex id per voxel, any spatial rank; ``luma`` may
    carry leading batch axes. Returns (ids, lattice extents)."""
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    vid = torch.zeros((), dtype=torch.int64, device=luma.device)
    for ax, s in enumerate(shape):
        idx = torch.div(torch.arange(s, device=luma.device), sigma_spatial,
                        rounding_mode="floor")
        vid = vid * ext[ax] + idx.reshape((s,) + (1,) * (len(shape) - ax - 1))
    return vid * ext[-1] + _luma_bins(luma, sigma_luma), ext


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous fp32, got {t.dtype}")


def _as_rank3(shape: tuple[int, ...], name: str) -> tuple[int, int, int]:
    """Spatial shape with missing leading axes as 1 (a lattice axis of extent
    1 changes neither the vertex order nor the blur)."""
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"{name} kernel takes 1-3 spatial axes, got {shape}")
    return (1,) * (3 - len(shape)) + tuple(shape)


def _launch(fn: str, device: torch.device, *args) -> None:
    lib = kernels.load_library()
    with torch.cuda.device(device):
        code = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    kernels.check(code, fn)


# ---------------------------------------------------------------- K4 splat

def bls_splat_plain(luma, target, confidence, sigma_spatial, sigma_luma):
    """(B, *shape) luma, target, confidence → (B, 3, n_cells, L) fp32:
    [count, Σc, Σt·c] per lattice vertex, by ``index_add_`` scatter."""
    B, shape = luma.shape[0], tuple(luma.shape[1:])
    vid, ext = _vertex_ids(shape, luma, sigma_spatial, sigma_luma)
    nverts = int(np.prod(ext))
    offs = torch.arange(B, device=luma.device).reshape((B,) + (1,) * len(shape))
    c = confidence.float()
    src = torch.stack([torch.ones_like(c), c, target.float() * c], dim=-1)
    out = torch.zeros((B * nverts, 3), dtype=torch.float32, device=luma.device)
    out.index_add_(0, (vid + offs * nverts).reshape(-1), src.reshape(-1, 3))
    return out.reshape(B, nverts, 3).permute(0, 2, 1).reshape(B, 3, -1, ext[-1])


def bls_splat(luma, target, confidence, sigma_spatial, sigma_luma):
    """``bls_splat_plain``'s result; the K4 kernel for CUDA tensors (fp32,
    contiguous, luma in [0, 255])."""
    if luma.device.type == "cpu":
        return bls_splat_plain(luma, target, confidence, sigma_spatial, sigma_luma)
    if luma.device.type != "cuda":
        raise ValueError(f"bls_splat: unsupported device {luma.device}")
    _check_kernel_inputs("bls_splat", luma, target, confidence)
    B, shape = luma.shape[0], tuple(luma.shape[1:])
    if target.shape != luma.shape or confidence.shape != luma.shape:
        raise ValueError("bls_splat: luma, target and confidence differ in shape")
    Z, Y, X = _as_rank3(shape, "bls_splat")
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    n_cells, L = int(np.prod(ext[:-1])), ext[-1]
    out = torch.empty((B, 3, n_cells, L), dtype=torch.float32, device=luma.device)
    _launch("vittf_bls_splat", luma.device, luma.data_ptr(), target.data_ptr(),
            confidence.data_ptr(), out.data_ptr(), B, Z, Y, X, int(sigma_spatial),
            float(sigma_luma), L)
    bls_splat.launches += 1
    return out


bls_splat.launches = 0


# ---------------------------------------------------------------- K5 slice

def bls_slice_plain(luma, grid, sigma_spatial, sigma_luma):
    """(B, *shape) luma and (B, n_cells, L) lattice values → (B, *shape):
    each voxel's vertex value, by indexing."""
    B, shape = luma.shape[0], tuple(luma.shape[1:])
    vid, _ = _vertex_ids(shape, luma, sigma_spatial, sigma_luma)
    return torch.gather(grid.reshape(B, -1), 1, vid.reshape(B, -1)).reshape(luma.shape)


def bls_slice(luma, grid, sigma_spatial, sigma_luma):
    """``bls_slice_plain``'s result; the K5 kernel for CUDA tensors."""
    if luma.device.type == "cpu":
        return bls_slice_plain(luma, grid, sigma_spatial, sigma_luma)
    if luma.device.type != "cuda":
        raise ValueError(f"bls_slice: unsupported device {luma.device}")
    _check_kernel_inputs("bls_slice", luma, grid)
    B, shape = luma.shape[0], tuple(luma.shape[1:])
    Z, Y, X = _as_rank3(shape, "bls_slice")
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    if grid.numel() != B * int(np.prod(ext)):
        raise ValueError(f"bls_slice: lattice {tuple(grid.shape)} is not ({B}, {ext})")
    out = torch.empty_like(luma)
    _launch("vittf_bls_slice", luma.device, luma.data_ptr(), grid.data_ptr(),
            out.data_ptr(), B, Z, Y, X, int(sigma_spatial), float(sigma_luma), ext[-1])
    bls_slice.launches += 1
    return out


bls_slice.launches = 0


# ----------------------------------------------------------------- K8 blur

def _shifted(y: torch.Tensor, ax: int, step: int) -> torch.Tensor:
    """out[i] = y[i + step] along ``ax`` (step ±1), zero past the edge."""
    n = y.shape[ax]
    zero = torch.zeros_like(y.narrow(ax, 0, 1))
    if step > 0:
        return torch.cat([y.narrow(ax, 1, n - 1), zero], dim=ax)
    return torch.cat([zero, y.narrow(ax, 0, n - 1)], dim=ax)


def _blur(y: torch.Tensor, blur_dim: int = _BLUR_DIM) -> torch.Tensor:
    """Plain dense lattice blur of (B, *ext): 2·dim·y + Σ_axes (y[+1] + y[−1])
    over every axis but the leading batch axis, zero boundaries (the JAX
    ``_blur``, in its order of additions)."""
    out = (2.0 * blur_dim) * y
    for ax in range(1, y.ndim):
        out = out + _shifted(y, ax, 1)
        out = out + _shifted(y, ax, -1)
    return out


def bls_blur(y: torch.Tensor, blur_dim: int = _BLUR_DIM) -> torch.Tensor:
    """``_blur``'s result; the K8 kernel for CUDA tensors of up to 4 lattice
    axes."""
    if y.device.type == "cpu":
        return _blur(y, blur_dim)
    if y.device.type != "cuda":
        raise ValueError(f"bls_blur: unsupported device {y.device}")
    _check_kernel_inputs("bls_blur", y)
    B, ext = y.shape[0], tuple(y.shape[1:])
    if not 2 <= len(ext) <= 4:
        raise ValueError(f"bls_blur kernel takes 2-4 lattice axes, got {ext}")
    Z, Y, X, L = (1,) * (4 - len(ext)) + ext
    out = torch.empty_like(y)
    _launch("vittf_bls_blur", y.device, y.data_ptr(), out.data_ptr(), B, Z, Y, X, L,
            int(blur_dim))
    bls_blur.launches += 1
    return out


bls_blur.launches = 0


# ------------------------------------------------------------------ solve

def _pixel_ops(pixel_impl: str):
    if pixel_impl == "auto":
        return bls_splat, bls_slice, bls_blur
    if pixel_impl == "scatter":
        return bls_splat_plain, bls_slice_plain, _blur
    raise ValueError(f"unknown pixel_impl: {pixel_impl}")


def _lattice_solve(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter,
                   bistoch_iters, blur_dim, blur=bls_blur):
    """Lattice-side solve for (B, nverts) splat(1), splat(c), splat(t·c):
    bistochastization, then Jacobi-PCG on A(y) = λ(Dm − Dn·blur·Dn)y +
    diag(splat(c))·y (reference bilateral_solver3d.py:107-154).

    The CG is ``jax.scipy.sparse.linalg.cg`` as the JAX twin runs it under
    ``vmap``: atol² = max(tol²·⟨b,b⟩, 0), and a class iterates while
    ⟨r,r⟩ > atol² and k < maxiter. The test stays on the device as a
    per-class mask that freezes x, r, p and γ once a class has converged, so
    the loop never waits on the host and runs at most ``cg_maxiter`` times.
    """
    B = m.shape[0]
    lat = (B,) + tuple(ext)

    def blur_flat(y):
        return blur(y.reshape(lat).contiguous(), blur_dim).reshape(B, -1)

    def dot(u, v):
        return (u * v).sum(dim=1)

    occupied = m > 0
    n = occupied.float()
    for _ in range(bistoch_iters):
        bn = blur_flat(n)
        n = torch.where(occupied, torch.sqrt(n * m / torch.where(bn > 0, bn, 1.0)), 0.0)
    m_b = n * blur_flat(n)
    y0 = torch.where(w_splat > 0, b / torch.where(w_splat > 0, w_splat, 1.0), 0.0)

    def A(y):
        smooth = m_b * y - n * blur_flat(n * y)
        return torch.where(occupied, lam * smooth + w_splat * y, y)  # identity on empty

    a_diag = lam * (m_b - 2.0 * blur_dim * n * n) + w_splat
    a_diag = torch.where(occupied, torch.clamp(a_diag, min=A_diag_min), 1.0)

    tol2 = torch.square(torch.tensor(cg_tol, dtype=torch.float32))
    atol2 = torch.clamp(tol2 * dot(b, b), min=0.0)
    x = y0
    r = b - A(x)
    p = z = r / a_diag
    gamma = dot(r, z)
    for _ in range(cg_maxiter):
        active = dot(r, r) > atol2
        Ap = A(p)
        alpha = (gamma / dot(p, Ap))[:, None]
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = r_new / a_diag
        gamma_new = dot(r_new, z)
        p_new = z + (gamma_new / gamma)[:, None] * p
        keep = active[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def bilateral_solve_gray_batched(
    target: torch.Tensor,  # (B, *spatial) float, 1-3 spatial axes
    luma: torch.Tensor,  # (B, *spatial) float in [0, 255]
    confidence: torch.Tensor,  # (B, *spatial) float
    sigma_spatial: int = 24,
    sigma_luma: int = 4,
    lam: float = 256.0,
    A_diag_min: float = 1e-5,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 25,
    bistoch_iters: int = 10,
    blur_dim: int = _BLUR_DIM,
    pixel_impl: str = "auto",
    coarse_to_fine: bool = False,
) -> torch.Tensor:
    """``bilateral_solve_gray`` for B independent problems in one pass: every
    tensor of the solve carries the leading axis, and each kernel launch
    serves all B. Returns (B, *spatial) fp32."""
    if coarse_to_fine:
        raise NotImplementedError(
            "coarse_to_fine=True: the coarse-to-fine solve of vittf_tpu is not ported"
        )
    splat, slice_, blur = _pixel_ops(pixel_impl)
    B, shape = target.shape[0], tuple(target.shape[1:])
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    lu = luma.float().contiguous()
    m, w_splat, b = splat(
        lu, target.float().contiguous(), confidence.float().contiguous(),
        sigma_spatial, sigma_luma,
    ).reshape(B, 3, -1).unbind(1)
    yhat = _lattice_solve(
        m, w_splat, b, ext, lam=lam, A_diag_min=A_diag_min, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, bistoch_iters=bistoch_iters, blur_dim=blur_dim,
        blur=blur,
    )
    out = slice_(lu, yhat.reshape(B, -1, ext[-1]).contiguous(), sigma_spatial, sigma_luma)
    return torch.nan_to_num(out)


def bilateral_solve_gray(target, luma, confidence, **kw) -> torch.Tensor:
    """Solve the bilateral-regularized least squares for one channel.

    ``target``, ``luma`` (values in [0, 255]) and ``confidence`` share one
    2D or 3D shape; keywords as ``bilateral_solve_gray_batched``.
    ``pixel_impl``: ``'auto'`` runs the splat, slice and blur kernels on
    CUDA tensors and their plain twins on CPU tensors; ``'scatter'`` runs the
    plain twins on any device. Algebraically identical to the reference's
    hashed-sparse solver restricted to occupied vertices; fp32 summation
    order differs between the forms.
    """
    return bilateral_solve_gray_batched(target[None], luma[None], confidence[None], **kw)[0]


def bilateral_filter_gray(x, luma, sigma_spatial: int, sigma_luma: int,
                          blur_dim: int = _BLUR_DIM) -> torch.Tensor:
    """Plain bilateral filter slice(blur(splat(x)))/slice(blur(splat(1)))
    (reference BilateralGrid.filter, :101-104): the oracle for the lattice
    operators, in the plain scatter/gather form on any device."""
    vid, ext = _vertex_ids(tuple(x.shape), luma, sigma_spatial, sigma_luma)
    vid = vid.reshape(-1)
    nverts = int(np.prod(ext))

    def filt(v):
        grid = torch.zeros(nverts, dtype=torch.float32, device=x.device).index_add_(0, vid, v)
        return _blur(grid.reshape((1,) + ext), blur_dim).reshape(-1)[vid]

    xf = x.reshape(-1).float()
    return (filt(xf) / filt(torch.ones_like(xf))).reshape(x.shape)


def apply_bilateral_solver3d(t, r, c=None, grid_params: dict | None = None,
                             bs_params: dict | None = None,
                             pixel_impl: str = "auto") -> torch.Tensor:
    """Reference-signature entry point (bilateral_solver3d.py:211-245).

    Args:
        t: target (1, W, H, D) or (W, H, D) float in [0, 1]
        r: reference image (3, W, H, D) uint8 [0, 255] (grayscale content:
           all channels equal; the dense lattice uses its luma)
        c: optional confidence (1, W, H, D); defaults to the inverted Sobel
           magnitude of r[0]/255 (reference :229-238)

    Returns:
        (W, H, D) float32 solved target.
    """
    gp = {**GRID_PARAMS_DEFAULT, **(grid_params or {})}
    bs = {**BS_PARAMS_DEFAULT, **(bs_params or {})}
    t = t.reshape(t.shape[-3:]).float()
    if c is None:
        sob = filter_sobel_separated(make_5d(r[0].float() / 255.0)).reshape(t.shape)
        c = sob.max() - sob
    else:
        c = c.reshape(t.shape).float()
    # luma of a grayscale RGB via the reference's RGB→YUV: Y = I exactly
    return bilateral_solve_gray(
        t, r[0].float(), c,
        sigma_spatial=int(gp["sigma_spatial"]),
        sigma_luma=int(gp["sigma_luma"]),
        lam=float(bs["lam"]),
        A_diag_min=float(bs["A_diag_min"]),
        cg_tol=float(bs["cg_tol"]),
        cg_maxiter=int(bs["cg_maxiter"]),
        pixel_impl=pixel_impl,
    )
