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
from ``vmap``. Each lattice operator has a hand-written CUDA kernel and a
plain PyTorch twin beside it: ``bls_splat``, ``bls_slice`` and ``bls_blur``
(``csrc/bilateral.cu``) work on raw voxels; ``bls_reblock``,
``bls_unreblock``, ``bls_splat_blocked`` and ``bls_slice_blocked``
(``csrc/bilateral_reblock.cu``) are the split form, in which pixels are first
grouped by spatial lattice cell. The lattice-side solve, bistochastization
and Jacobi-PCG, is one launch of ``lattice_solve`` (K12,
``csrc/lattice_solve.cu``), whose plain twin ``_lattice_solve`` runs it op by
op around ``bls_blur``. Each wrapper launches its kernel for CUDA tensors and
runs its twin for CPU tensors; ``pixel_impl='scatter'`` runs the
scatter/gather twins on any device. The TPU lowerings ``'scan'`` and
``'pallas_interpret'`` are not ported. On CUDA tensors the kernel forms of
the solve run as one captured CUDA graph per shape and static arguments,
the counterpart of the JAX twin's ``jax.jit``.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import math

import numpy as np
import torch

from vittf_tpu_torch import kernels
from vittf_tpu_torch.ops.morphology import filter_sobel_separated
from vittf_tpu_torch.utils import cuda_graphs
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
MAX_SPLAT_BINS = 256  # the splat kernels keep a cell's luma bins in a warp's registers, 8 a lane


def _cell_extents(shape, sigma_spatial):
    return tuple(int((s - 1) // sigma_spatial) + 1 for s in shape)


def _grid_extents(shape, sigma_spatial, sigma_luma):
    return _cell_extents(shape, sigma_spatial) + (int(255.0 / sigma_luma) + 1,)


def _luma_bins(luma: torch.Tensor, sigma_luma) -> torch.Tensor:
    """int(luma / σ_l) per voxel, truncated toward zero. The divisor is a
    tensor on luma's device: PyTorch divides a CUDA tensor by a Python scalar
    as a multiply by its reciprocal, which can move a knife-edge voxel into
    the neighbouring bin. The kernels divide too. The divisor is filled on
    the device, not copied from the host, so that a solve can be captured in
    a CUDA graph."""
    sl = torch.full((), float(sigma_luma), dtype=torch.float32, device=luma.device)
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


def _check_kernel_inputs(name: str, *tensors: torch.Tensor,
                         dtypes=(torch.float32,)) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous {dtypes}, got {t.dtype}")


def _as_rank3(shape: tuple[int, ...], name: str) -> tuple[int, int, int]:
    """Spatial shape with missing leading axes as 1 (a lattice axis of extent
    1 changes neither the vertex order nor the blur)."""
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"{name} kernel takes 1-3 spatial axes, got {shape}")
    return (1,) * (3 - len(shape)) + tuple(shape)


def _launch(fn: str, device: torch.device, *args) -> None:
    """Launch entry point ``fn`` on ``device``'s current stream; raises on a
    launch error. The current device is switched only when it is not
    ``device`` (the switch is host time on every short launch)."""
    lib = kernels.load_library()
    if device.index == torch.cuda.current_device():
        code = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            code = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if code:
        kernels.check(code, fn)


@functools.lru_cache(maxsize=256)
def _div_magic(d: int) -> tuple[int, int]:
    """(m, s) with n // d == (n * m) >> s for every 0 <= n < 2**31: the
    slices' multiply-high division (``csrc/slice_walk.cuh``, ``Magic``).
    s = 31 + ceil(log2 d) and m = ceil(2**s / d) < 2**32: m exceeds 2**s / d
    by less than 1, so n * m / 2**s exceeds n / d by less than
    2**31 / 2**s <= 1 / d and never reaches the next integer."""
    if not 1 <= d < 2**31:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def _magic_word(d: int) -> int:
    """``_div_magic(d)`` as the kernels take it: m | s << 32."""
    m, s = _div_magic(d)
    return m | s << 32


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (the slices read and write 16-byte runs)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    contiguous, luma in [0, 255]). The kernel sums every vertex in ascending
    voxel order without atomics: it equals the plain twin run on CPU tensors
    bit for bit, and its own repeat (the twin's ``index_add_`` is atomic on a
    CUDA tensor and is not repeatable there)."""
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
    n_cells, L = math.prod(ext[:-1]), ext[-1]
    if L > MAX_SPLAT_BINS:
        raise ValueError(f"bls_splat kernel takes at most {MAX_SPLAT_BINS} luma bins, got {L}")
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
    """``bls_slice_plain``'s result; the K5 kernel for CUDA tensors (fp32,
    contiguous). The kernel bins by true division, as the twin does."""
    if luma.device.type == "cpu":
        return bls_slice_plain(luma, grid, sigma_spatial, sigma_luma)
    if luma.device.type != "cuda":
        raise ValueError(f"bls_slice: unsupported device {luma.device}")
    _check_kernel_inputs("bls_slice", luma, grid)
    B, shape = luma.shape[0], tuple(luma.shape[1:])
    Z, Y, X = _as_rank3(shape, "bls_slice")
    ss = int(sigma_spatial)
    ext = _grid_extents(shape, ss, sigma_luma)
    if grid.numel() != B * math.prod(ext):
        raise ValueError(f"bls_slice: lattice {tuple(grid.shape)} is not ({B}, {ext})")
    luma = _aligned16(luma)
    out = torch.empty_like(luma)
    _launch("vittf_bls_slice", luma.device, luma.data_ptr(), grid.data_ptr(),
            out.data_ptr(), B, Z, Y, X, ss, float(sigma_luma), ext[-1],
            _magic_word(X), _magic_word(Y), _magic_word(ss))
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
    """``_blur``'s result, bit for bit; the K8 kernel for CUDA tensors of up
    to 4 lattice axes."""
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


# ------------------------------------------------- blocked pixel views

def _blocked_pixel_view(x: torch.Tensor, ss: int, sp_ext, fill=0) -> torch.Tensor:
    """(B, *shape) pixels → (B, n_cells, ss**rank), grouped by spatial lattice
    cell. The cell of pixel i along any axis is i // ss, so one cell's pixels
    form an axis-aligned ss**rank block; the last block per axis may be
    partial and is padded with ``fill``. Plain reshapes, outside any kernel
    (as in the JAX twin), for the ranks other than 3."""
    B, shape = x.shape[0], tuple(x.shape[1:])
    r = len(shape)
    padded = tuple(e * ss for e in sp_ext)
    if padded != shape:
        xp = x.new_full((B,) + padded, fill)
        xp[(slice(None),) + tuple(slice(0, s) for s in shape)] = x
        x = xp
    xb = x.reshape((B,) + sum(((e, ss) for e in sp_ext), ()))
    perm = [0] + [1 + 2 * i for i in range(r)] + [2 + 2 * i for i in range(r)]
    return xb.permute(perm).reshape(B, int(np.prod(sp_ext)), ss**r)


def _unblock_pixel_view(xb: torch.Tensor, ss: int, sp_ext, shape) -> torch.Tensor:
    """Inverse of ``_blocked_pixel_view``: (B, n_cells, ss**rank) → (B, *shape)."""
    B, r = xb.shape[0], len(shape)
    xb = xb.reshape((B,) + tuple(sp_ext) + (ss,) * r)
    perm = [0] + sum(([1 + i, 1 + r + i] for i in range(r)), [])
    xp = xb.permute(perm).reshape((B,) + tuple(e * ss for e in sp_ext))
    return xp[(slice(None),) + tuple(slice(0, s) for s in shape)]


# ------------------------------------------------- K6 reblock / unreblock

@functools.lru_cache(maxsize=256)
def _fill_bits(fill, dtype: torch.dtype) -> int:
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return int(np.array(fill, dtype=np_dtype).view(np.uint32))


def bls_reblock_plain(x: torch.Tensor, ss: int, fill=0) -> torch.Tensor:
    """(B, Z, Y, X) → (B, n_cells·ss, ss²): row ``cell·ss + dx`` holds pixel
    column dx of spatial cell (cz, cy, cx), lane ``dz·ss + dy``; slots past
    the volume hold ``fill``. This is the rank-3 layout of the split form,
    not ``_blocked_pixel_view``'s (whose rows hold a whole cell)."""
    B, (Z, Y, X) = x.shape[0], x.shape[1:]
    ncz, ncy, ncx = _cell_extents((Z, Y, X), ss)
    xp = x.new_full((B, ncz * ss, ncy * ss, ncx * ss), fill)
    xp[:, :Z, :Y, :X] = x
    xb = xp.reshape(B, ncz, ss, ncy, ss, ncx, ss)  # b cz dz cy dy cx dx
    return xb.permute(0, 1, 3, 5, 6, 2, 4).reshape(B, ncz * ncy * ncx * ss, ss * ss)


def bls_unreblock_plain(xb: torch.Tensor, ss: int, shape) -> torch.Tensor:
    """Inverse of ``bls_reblock_plain``, cropped to (B, *shape)."""
    B, (Z, Y, X) = xb.shape[0], shape
    ncz, ncy, ncx = _cell_extents((Z, Y, X), ss)
    x = xb.reshape(B, ncz, ncy, ncx, ss, ss, ss)  # b cz cy cx dx dz dy
    x = x.permute(0, 1, 5, 2, 6, 3, 4).reshape(B, ncz * ss, ncy * ss, ncx * ss)
    return x[:, :Z, :Y, :X].contiguous()


def bls_reblock(x: torch.Tensor, ss: int, fill=0) -> torch.Tensor:
    """``bls_reblock_plain``'s result; the K6a kernel for CUDA tensors
    (contiguous int32 or fp32, moved as 32-bit words)."""
    if x.device.type == "cpu":
        return bls_reblock_plain(x, ss, fill)
    if x.device.type != "cuda":
        raise ValueError(f"bls_reblock: unsupported device {x.device}")
    _check_kernel_inputs("bls_reblock", x, dtypes=(torch.float32, torch.int32))
    if x.ndim != 4:
        raise ValueError(f"bls_reblock kernel takes (B, Z, Y, X), got {tuple(x.shape)}")
    B, Z, Y, X = x.shape
    n_cells = math.prod(_cell_extents((Z, Y, X), ss))
    out = torch.empty((B, n_cells * ss, ss * ss), dtype=x.dtype, device=x.device)
    _launch("vittf_bls_reblock", x.device, x.data_ptr(), out.data_ptr(), B, Z, Y, X,
            int(ss), _fill_bits(fill, x.dtype))
    bls_reblock.launches += 1
    return out


bls_reblock.launches = 0


def bls_unreblock(xb: torch.Tensor, ss: int, shape) -> torch.Tensor:
    """``bls_unreblock_plain``'s result; the K6b kernel for CUDA tensors."""
    if xb.device.type == "cpu":
        return bls_unreblock_plain(xb, ss, shape)
    if xb.device.type != "cuda":
        raise ValueError(f"bls_unreblock: unsupported device {xb.device}")
    _check_kernel_inputs("bls_unreblock", xb, dtypes=(torch.float32, torch.int32))
    B, (Z, Y, X) = xb.shape[0], shape
    n_cells = math.prod(_cell_extents((Z, Y, X), ss))
    if tuple(xb.shape[1:]) != (n_cells * ss, ss * ss):
        raise ValueError(f"bls_unreblock: {tuple(xb.shape)} is not the blocked form of {shape}")
    out = torch.empty((B, Z, Y, X), dtype=xb.dtype, device=xb.device)
    _launch("vittf_bls_unreblock", xb.device, xb.data_ptr(), out.data_ptr(), B, Z, Y, X,
            int(ss))
    bls_unreblock.launches += 1
    return out


bls_unreblock.launches = 0


# --------------------------------------------- K7 blocked splat / slice

def bls_splat_blocked_plain(il_b, c_b, tc_b, L: int, groups: int = 1) -> torch.Tensor:
    """(B, n_cells·G, PB) luma bins (int32) and value planes c, t·c →
    (B, 3, n_cells, L) fp32: [count, Σc, Σt·c] per (cell, bin) over the
    cell's G rows, by ``index_add_``. A bin outside [0, L) adds nothing."""
    B, n_rows, _ = il_b.shape
    n_cells = n_rows // groups
    bins = il_b.long()
    valid = (bins >= 0) & (bins < L)
    cell = torch.arange(n_rows, device=il_b.device).div(groups, rounding_mode="floor")
    offs = torch.arange(B, device=il_b.device).reshape(B, 1, 1) * n_cells
    vid = torch.where(valid, (offs + cell.reshape(1, -1, 1)) * L + bins, 0)
    w = valid.float()
    src = torch.stack([w, c_b.float() * w, tc_b.float() * w], dim=-1)
    out = torch.zeros((B * n_cells * L, 3), dtype=torch.float32, device=il_b.device)
    out.index_add_(0, vid.reshape(-1), src.reshape(-1, 3))
    return out.reshape(B, n_cells * L, 3).permute(0, 2, 1).reshape(B, 3, n_cells, L)


def bls_splat_blocked(il_b, c_b, tc_b, L: int, groups: int = 1) -> torch.Tensor:
    """``bls_splat_blocked_plain``'s result; the K7a kernel for CUDA tensors
    (contiguous int32 bins, fp32 planes). Like ``bls_splat`` the kernel sums
    in ascending slot order without atomics and equals the plain twin run on
    CPU tensors bit for bit."""
    if il_b.device.type == "cpu":
        return bls_splat_blocked_plain(il_b, c_b, tc_b, L, groups)
    if il_b.device.type != "cuda":
        raise ValueError(f"bls_splat_blocked: unsupported device {il_b.device}")
    _check_kernel_inputs("bls_splat_blocked", il_b, dtypes=(torch.int32,))
    _check_kernel_inputs("bls_splat_blocked", c_b, tc_b)
    if il_b.ndim != 3 or c_b.shape != il_b.shape or tc_b.shape != il_b.shape \
            or c_b.device != il_b.device or il_b.shape[1] % groups:
        raise ValueError("bls_splat_blocked: bins and planes differ, or rows are not cells·G")
    if L > MAX_SPLAT_BINS:
        raise ValueError(f"bls_splat_blocked kernel takes at most {MAX_SPLAT_BINS} bins, got {L}")
    B, n_rows, PB = il_b.shape
    n_cells = n_rows // groups
    out = torch.empty((B, 3, n_cells, L), dtype=torch.float32, device=il_b.device)
    _launch("vittf_bls_splat_blocked", il_b.device, il_b.data_ptr(), c_b.data_ptr(),
            tc_b.data_ptr(), out.data_ptr(), B, n_cells, groups * PB, int(L))
    bls_splat_blocked.launches += 1
    return out


bls_splat_blocked.launches = 0


def bls_slice_blocked_plain(il_b, yl, groups: int = 1) -> torch.Tensor:
    """``out[b, row, p] = yl[b, row // G, il_b[b, row, p]]``, 0 where the bin
    is outside [0, L): (B, n_cells·G, PB) int32 bins and (B, n_cells, L)
    lattice values → (B, n_cells·G, PB) fp32, by indexing."""
    B, n_rows, PB = il_b.shape
    L = yl.shape[-1]
    bins = il_b.long()
    valid = (bins >= 0) & (bins < L)
    rows = yl.repeat_interleave(groups, dim=1) if groups > 1 else yl  # (B, n_rows, L)
    got = torch.gather(rows, 2, torch.where(valid, bins, 0))
    return torch.where(valid, got, 0.0)


def bls_slice_blocked(il_b, yl, groups: int = 1) -> torch.Tensor:
    """``bls_slice_blocked_plain``'s result; the K7b kernel for CUDA tensors
    (contiguous int32 bins, fp32 lattice)."""
    if il_b.device.type == "cpu":
        return bls_slice_blocked_plain(il_b, yl, groups)
    if il_b.device.type != "cuda":
        raise ValueError(f"bls_slice_blocked: unsupported device {il_b.device}")
    _check_kernel_inputs("bls_slice_blocked", il_b, dtypes=(torch.int32,))
    _check_kernel_inputs("bls_slice_blocked", yl)
    B, n_rows, PB = il_b.shape
    n_cells = n_rows // groups
    if yl.device != il_b.device or n_rows % groups or tuple(yl.shape[:2]) != (B, n_cells):
        raise ValueError(f"bls_slice_blocked: lattice {tuple(yl.shape)} is not ({B}, {n_cells}, L)")
    il_b = _aligned16(il_b)
    out = torch.empty((B, n_rows, PB), dtype=torch.float32, device=il_b.device)
    _launch("vittf_bls_slice_blocked", il_b.device, il_b.data_ptr(), yl.data_ptr(),
            out.data_ptr(), B, n_cells, groups * PB, int(yl.shape[-1]),
            _magic_word(groups * PB))
    bls_slice_blocked.launches += 1
    return out


bls_slice_blocked.launches = 0


# ------------------------------------------------------------------ solve

def _pixel_ops(pixel_impl: str, rank: int):
    """→ (form, solve): the pixel↔lattice transfer form ('fused', 'blocked' or
    'scatter') and the lattice-side solve for a solve of ``rank`` spatial axes:
    K12 (``lattice_solve``) in the kernel forms, the per-op ``_lattice_solve``
    with the plain blur for 'scatter'."""
    if pixel_impl == "auto":  # the JAX twin's 'pallas': fused kernels in 3D only
        return ("fused" if rank == 3 else "blocked"), lattice_solve
    if pixel_impl == "reblock":
        return "blocked", lattice_solve
    if pixel_impl == "scatter":
        return "scatter", functools.partial(_lattice_solve, blur=_blur)
    raise ValueError(f"unknown pixel_impl: {pixel_impl}")


def _blocked_transfer(lu, t, c, ss: int, sigma_luma, ext):
    """The split form: cell-blocked bins and value planes feed the blocked
    splat; the returned slice reads the same bins. Rank 3 blocks and unblocks
    with the K6 kernels (G = ss rows per cell), other ranks with plain
    reshapes (G = 1). Bins and t·c are computed here, before any kernel.
    Returns ((B, 3, n_cells, L) splat, slice function)."""
    shape, sp_ext, L = tuple(lu.shape[1:]), ext[:-1], ext[-1]
    bins = _luma_bins(lu, sigma_luma).to(torch.int32)
    if len(shape) == 3:
        groups = ss

        def block(x, fill=0):
            return bls_reblock(x.contiguous(), ss, fill)

        def unblock(xb):
            return bls_unreblock(xb, ss, shape)
    else:
        groups = 1

        def block(x, fill=0):
            return _blocked_pixel_view(x, ss, sp_ext, fill).contiguous()

        def unblock(xb):
            return _unblock_pixel_view(xb, ss, sp_ext, shape)

    il_b = block(bins, -1)
    splat3 = bls_splat_blocked(il_b, block(c), block(t * c), L, groups)

    def slice_(yl):
        return unblock(bls_slice_blocked(il_b, yl, groups))

    return splat3, slice_


def _sumpool2(x: torch.Tensor, ext_c) -> torch.Tensor:
    """2× sum-pool every lattice axis of (B, *ext), ragged edges zero-padded.

    The restriction of the coarse-to-fine solve: pixel→cell and luma→bin
    indices compose exactly under σ-doubling (p // ss // 2 == p // (2·ss)),
    so the σ-doubled problem's splat is exactly the 2× sum-pool of the fine
    splat, with no second pass over the pixels."""
    for ax, ec in enumerate(ext_c, start=1):
        e = x.shape[ax]
        if e < 2 * ec:
            pad = x.new_zeros(x.shape[:ax] + (2 * ec - e,) + x.shape[ax + 1:])
            x = torch.cat([x, pad], dim=ax)
        x = x.reshape(x.shape[:ax] + (ec, 2) + x.shape[ax + 1:]).sum(dim=ax + 1)
    return x


def _prolong2(y: torch.Tensor, ext_f) -> torch.Tensor:
    """Nearest 2× prolongation of (B, *ext_c), cropped to the fine extents:
    fine vertex (i, …, l) reads coarse vertex (i // 2, …, l // 2)."""
    for ax in range(1, y.ndim):
        y = y.repeat_interleave(2, dim=ax)
    return y[(slice(None),) + tuple(slice(0, e) for e in ext_f)]


def _lattice_solve(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter,
                   bistoch_iters, blur_dim, blur=bls_blur, y0=None):
    """Lattice-side solve for (B, nverts) splat(1), splat(c), splat(t·c):
    bistochastization, then Jacobi-PCG on A(y) = λ(Dm − Dn·blur·Dn)y +
    diag(splat(c))·y (reference bilateral_solver3d.py:107-154), op by op: the
    plain twin of K12 (``lattice_solve``), which runs it in one launch on CUDA
    tensors in the kernel forms, and the solve of 'scatter' and of CPU
    tensors. Shared by the direct solve and both levels of the coarse-to-fine
    solve; ``y0`` replaces the b / splat(c) start (the coarse-to-fine
    prolongation).

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
    if y0 is None:
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


# ---------------------------------------------------------- K12 lattice solve

SOLVE_VECTORS = {"resident": 11, "streamed": 9}  # words a vertex keeps (lattice_solve.cu)
SOLVE_SHARED_BYTES = 224 * 1024  # dynamic shared memory a resident block may take


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """One K12 launch: classes [c0, c1), each cut into ``segments`` runs of
    ``seg`` vertices, one block a run; ``resident`` keeps a block's state in
    shared memory, else it streams from a device scratch."""
    c0: int
    c1: int
    segments: int
    seg: int
    resident: bool

    @property
    def blocks(self) -> int:
        return (self.c1 - self.c0) * self.segments


def _solve_plan(B: int, nverts: int, n_sms: int) -> list[SolvePlan]:
    """K12's launches for B classes of ``nverts`` vertices on a card of
    ``n_sms`` SMs: at most ``n_sms`` classes a launch (one in every call the
    port makes), each class cut into equal runs, 32-vertex aligned, so that
    the launch has at most ``n_sms`` blocks, one resident on each SM. A run
    of ``seg`` vertices is resident when its ``SOLVE_VECTORS['resident']``
    vectors fit in ``SOLVE_SHARED_BYTES``: the shape alone decides."""
    if B < 1 or nverts < 1 or n_sms < 1:
        raise ValueError(f"lattice solve plan: B {B}, {nverts} vertices, {n_sms} SMs")
    plans = []
    for c0 in range(0, B, n_sms):
        c1 = min(B, c0 + n_sms)
        per_class = n_sms // (c1 - c0)
        seg = -(-nverts // per_class)
        seg = -(-seg // 32) * 32
        resident = 4 * SOLVE_VECTORS["resident"] * seg <= SOLVE_SHARED_BYTES
        plans.append(SolvePlan(c0, c1, -(-nverts // seg), seg, resident))
    return plans


def lattice_solve(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter, bistoch_iters,
                  blur_dim, y0=None):
    """``_lattice_solve``'s result with the lattice blur ``bls_blur``: the K12
    kernel for CUDA tensors (one launch a call, ``SolvePlan``), the per-op
    twin for CPU tensors. m, w_splat, b: (B, nverts) fp32 rows with unit
    stride and one class stride (the unbound planes of a splat), nverts =
    prod(ext) over 2-4 lattice axes; ``y0`` a contiguous (B, nverts) start.
    K12 computes every vertex by the twin's formulas and sums its dots in a
    fixed order of its own: it equals its repeat bit for bit, and the twin
    to the rounding of those sums."""
    if m.device.type == "cpu":
        return _lattice_solve(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter,
                              bistoch_iters, blur_dim, blur=bls_blur, y0=y0)
    if m.device.type != "cuda":
        raise ValueError(f"lattice_solve: unsupported device {m.device}")
    return _solve_launch(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter,
                         bistoch_iters, blur_dim, y0)


def _check_solve_inputs(m, w_splat, b, ext, y0) -> tuple[int, ...]:
    """Raise on what K12 does not take; returns the lattice as (Z, Y, X, L)."""
    ext = tuple(int(e) for e in ext)
    if not 2 <= len(ext) <= 4:
        raise ValueError(f"lattice_solve kernel takes 2-4 lattice axes, got {ext}")
    B, nverts = m.shape[0], math.prod(ext)
    for t in (m, w_splat, b) + (() if y0 is None else (y0,)):
        if t.device != m.device:
            raise ValueError(f"lattice_solve: tensors on {t.device} and {m.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"lattice_solve kernel takes fp32, got {t.dtype}")
        if tuple(t.shape) != (B, nverts):
            raise ValueError(f"lattice_solve: {tuple(t.shape)} is not ({B}, {nverts}) of {ext}")
    if any(t.stride(1) != 1 or t.stride(0) != m.stride(0) for t in (m, w_splat, b)):
        raise ValueError("lattice_solve kernel takes m, w, b rows of unit stride at one "
                         "class stride")
    if y0 is not None and not y0.is_contiguous():
        raise ValueError("lattice_solve kernel takes a contiguous y0")
    if nverts >= 2**31:
        raise ValueError(f"lattice_solve kernel takes < 2**31 vertices a class, got {nverts}")
    return (1,) * (4 - len(ext)) + ext


def _solve_launch(m, w_splat, b, ext, lam, A_diag_min, cg_tol, cg_maxiter, bistoch_iters,
                  blur_dim, y0):
    """K12's launches on CUDA tensors, one per ``SolvePlan``; the inputs are
    checked before any. Each launch is cooperative: the driver starts it only
    with all of its blocks (at most one an SM) resident at once, or refuses
    it, so that its grid barriers never wait on a block that does not run;
    a stream capture records it as one cooperative kernel node."""
    Z, Y, X, L = _check_solve_inputs(m, w_splat, b, ext, y0)
    B, nverts = m.shape
    tol2 = float(np.square(np.float32(cg_tol)))  # torch.square of the fp32 tolerance
    n_sms = torch.cuda.get_device_properties(m.device).multi_processor_count
    out = torch.empty((B, nverts), dtype=torch.float32, device=m.device)
    for plan in _solve_plan(B, nverts, n_sms):
        Bg = plan.c1 - plan.c0
        u = torch.empty(2 * Bg * nverts, dtype=torch.float32, device=m.device)
        state = None if plan.resident else torch.empty(
            SOLVE_VECTORS["streamed"] * plan.blocks * plan.seg, dtype=torch.float32,
            device=m.device)
        count = torch.zeros(1 + 4 * plan.blocks, dtype=torch.int32, device=m.device)
        _launch("vittf_lattice_solve", m.device, m[plan.c0].data_ptr(),
                w_splat[plan.c0].data_ptr(), b[plan.c0].data_ptr(), m.stride(0),
                None if y0 is None else y0[plan.c0].data_ptr(), out[plan.c0].data_ptr(),
                u.data_ptr(), None if state is None else state.data_ptr(), count.data_ptr(),
                Bg, Z, Y, X, L, int(blur_dim), plan.segments, plan.seg, int(plan.resident),
                float(lam), float(A_diag_min), tol2, int(bistoch_iters), int(cg_maxiter))
        lattice_solve.launches += 1
    return out


lattice_solve.launches = 0


def _bilateral_solve_eager(
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
    fine_maxiter: int = 10,
) -> torch.Tensor:
    """``bilateral_solve_gray_batched`` op by op from the host: the route of
    CPU tensors and of ``'scatter'``, the body every captured graph holds,
    and the witness the graphs are held against."""
    B, shape = target.shape[0], tuple(target.shape[1:])
    form, solve = _pixel_ops(pixel_impl, len(shape))
    ext = _grid_extents(shape, sigma_spatial, sigma_luma)
    lu = luma.float().contiguous()
    t, c = target.float().contiguous(), confidence.float().contiguous()
    if form == "blocked":
        splat3, slice_ = _blocked_transfer(lu, t, c, sigma_spatial, sigma_luma, ext)
    else:
        splat, slice_raw = (bls_splat, bls_slice) if form == "fused" else (
            bls_splat_plain, bls_slice_plain)
        splat3 = splat(lu, t, c, sigma_spatial, sigma_luma)

        def slice_(yl):
            return slice_raw(lu, yl, sigma_spatial, sigma_luma)

    m, w_splat, b = splat3.reshape(B, 3, -1).unbind(1)
    solve_kw = dict(lam=lam, A_diag_min=A_diag_min, cg_tol=cg_tol,
                    bistoch_iters=bistoch_iters, blur_dim=blur_dim)
    if coarse_to_fine and all(e >= 2 for e in ext):
        # two levels: the σ-doubled coarse problem is the 2× sum-pool of the
        # fine splat (exact, see _sumpool2), solved to cg_maxiter, and its
        # prolonged solution starts the fine CG, which then runs
        # fine_maxiter steps. The fine problem is the direct solve's own, so
        # the two differ by CG convergence only.
        ext_c = _grid_extents(shape, 2 * sigma_spatial, 2 * sigma_luma)
        mc, wc, bc = (_sumpool2(v.reshape((B,) + ext), ext_c).reshape(B, -1)
                      for v in (m, w_splat, b))
        yc = solve(mc, wc, bc, ext_c, cg_maxiter=cg_maxiter, **solve_kw)
        y0 = _prolong2(yc.reshape((B,) + ext_c), ext).reshape(B, -1)
        y0 = torch.where(m > 0, y0, 0.0)  # empty vertices are identity rows: keep 0
        yhat = solve(m, w_splat, b, ext, cg_maxiter=fine_maxiter, y0=y0, **solve_kw)
    else:
        yhat = solve(m, w_splat, b, ext, cg_maxiter=cg_maxiter, **solve_kw)
    out = slice_(yhat.reshape(B, -1, ext[-1]).contiguous())
    return torch.nan_to_num(out)


# ------------------------------------------------------------ solve graphs

# the JAX twin's static_argnames but pixel_impl, which the key holds as its form
_STATIC_ARGS = ("sigma_spatial", "sigma_luma", "lam", "A_diag_min", "cg_tol", "cg_maxiter",
                "bistoch_iters", "blur_dim", "coarse_to_fine", "fine_maxiter")
_SOLVE_DEFAULTS = {name: p.default for name, p in
                   inspect.signature(_bilateral_solve_eager).parameters.items()
                   if p.default is not inspect.Parameter.empty}
_WRAPPERS = (bls_splat, bls_slice, bls_blur, bls_reblock, bls_unreblock, bls_splat_blocked,
             bls_slice_blocked, lattice_solve)


def _graph_key(device: torch.device, shape, kw: dict) -> tuple:
    """What a captured solve is specific to: the device, (B, *spatial), the
    pixel↔lattice form and every static argument of ``kw`` (the JAX twin's
    ``jax.jit`` key; an argument ``kw`` leaves out takes its default).
    2-D ``'auto'`` and ``'reblock'`` are one form."""
    kw = {**_SOLVE_DEFAULTS, **kw}
    form, _ = _pixel_ops(kw["pixel_impl"], len(shape) - 1)
    return (device.index, tuple(shape), form) + tuple(kw[name] for name in _STATIC_ARGS)


def _graphed_solve(target, luma, confidence, kw: dict) -> torch.Tensor:
    """The solve of CUDA tensors in a kernel form through the graph cache
    (``utils/cuda_graphs.py``): eager on its key's first call, captured on
    the second, replayed after; on fp32 inputs."""
    if luma.shape != target.shape or confidence.shape != target.shape:
        raise ValueError("bilateral solve: target, luma and confidence differ in shape")
    if luma.device != target.device or confidence.device != target.device:
        raise ValueError("bilateral solve: target, luma and confidence on different devices")
    key = _graph_key(target.device, target.shape, kw)
    return cuda_graphs.graphed(key, tuple(x.float() for x in (target, luma, confidence)),
                               functools.partial(_bilateral_solve_eager, **kw), _WRAPPERS)


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
    fine_maxiter: int = 10,
) -> torch.Tensor:
    """``bilateral_solve_gray`` for B independent problems in one pass: every
    tensor of the solve carries the leading axis, and each kernel launch
    serves all B. Returns (B, *spatial) fp32.

    On CUDA tensors in a kernel form (``'auto'``, ``'reblock'``) the solve
    goes through the port's graph cache (``utils/cuda_graphs.py``), one
    CUDA graph per key (``_graph_key``: device, shape, form and the static
    arguments, as the JAX twin's ``jax.jit``): the key's first call runs the
    eager body, the second captures it and replays, later calls replay; the
    same kernels in the same order, so the answer is the eager body's bit
    for bit. The cache keeps ``GRAPH_BOUND`` graphs within a byte budget. A
    capture or replay error raises. CPU tensors and ``'scatter'`` run the
    eager body."""
    kw = dict(sigma_spatial=sigma_spatial, sigma_luma=sigma_luma, lam=lam,
              A_diag_min=A_diag_min, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
              bistoch_iters=bistoch_iters, blur_dim=blur_dim, pixel_impl=pixel_impl,
              coarse_to_fine=coarse_to_fine, fine_maxiter=fine_maxiter)
    form, _ = _pixel_ops(pixel_impl, target.ndim - 1)
    if target.device.type != "cuda" or form == "scatter":
        return _bilateral_solve_eager(target, luma, confidence, **kw)
    return _graphed_solve(target, luma, confidence, kw)


def bilateral_solve_gray(target, luma, confidence, **kw) -> torch.Tensor:
    """Solve the bilateral-regularized least squares for one channel.

    ``target``, ``luma`` (values in [0, 255]) and ``confidence`` share one
    2D or 3D shape; keywords as ``bilateral_solve_gray_batched``.
    ``pixel_impl`` picks the pixel↔lattice transfer:

    - ``'auto'``: in 3D the fused splat and slice (K4, K5) on raw voxels; in
      any other rank the split form below (as the JAX twin's ``'pallas'``).
    - ``'reblock'``: the split form (the JAX twin's ``'pallas_reblock'``):
      luma bins, c and t·c are grouped by lattice cell (rank 3: the K6
      transposes; other ranks: plain reshapes) and feed the blocked splat and
      slice (K7). Kept in 3D as the witness of the fused kernels.
    - ``'scatter'``: the plain scatter/gather twins on any device.

    On CPU tensors every kernel wrapper runs its plain twin.
    ``coarse_to_fine`` warm-starts the CG from a σ-doubled coarse solve and
    runs ``fine_maxiter`` fine steps; it needs every lattice extent ≥ 2 and
    falls back to the direct solve below that. All forms are algebraically
    identical to the reference's hashed-sparse solver restricted to occupied
    vertices; fp32 summation order differs between them.
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


def apply_bilateral_solver2d(t, r, c=None, grid_params: dict | None = None,
                             bs_params: dict | None = None,
                             pixel_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """2D bilateral solver + island post-filter (reference bilateral_solver.py).

    Args:
        t: target (1, W, H) or (W, H) float in [0, 1]
        r: grayscale reference (1, W, H) or (W, H), value range [0, 255]
        c: optional confidence; defaults to constant 0.999 (reference :189)

    Returns:
        (binary, solved): the fill-holes + largest-foreground-island binary
        mask as fp32 (all ones when no foreground exists, the reference's
        fallback) and the raw solved float map.
    """
    from vittf_tpu_torch.ops.connected import largest_component_2d
    from vittf_tpu_torch.ops.morphology import binary_fill_holes

    gp = {**GRID_PARAMS_DEFAULT, **(grid_params or {})}
    bs = {**BS_PARAMS_DEFAULT, **(bs_params or {})}
    t = t.reshape(t.shape[-2:]).float()
    r = r.reshape(t.shape).float()
    c = torch.full_like(t, 0.999) if c is None else c.reshape(t.shape).float()
    out = bilateral_solve_gray(
        t, r, c,
        sigma_spatial=int(gp["sigma_spatial"]),
        sigma_luma=int(gp["sigma_luma"]),
        lam=float(bs["lam"]),
        A_diag_min=float(bs["A_diag_min"]),
        cg_tol=float(bs["cg_tol"]),
        cg_maxiter=int(bs["cg_maxiter"]),
        blur_dim=_BLUR_DIM_2D,
        pixel_impl=pixel_impl,
    )
    filled = binary_fill_holes(out > 0.5)
    binary = largest_component_2d(filled)
    binary = torch.where(filled.any(), binary, torch.ones_like(binary))
    return binary.float(), out


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
