"""Synthetic SDF volume fixtures (spheres / tori, filled & shell) and the
labeled phantoms of the quality experiments.

Port of ``vittf_tpu/core/synthetic.py`` (reference create_synthetic_volumes.py).
Volumes are evaluated on ``device`` (the first CUDA device when None, or
``'cpu'``) and returned as tensors there. Grids and arithmetic follow the
JAX twin operation for operation, so noise-free fixtures equal it.

The JAX twin's SDF fixtures draw their noise from ``jax.random`` on a
threefry key, whose bits torch cannot draw. Here every noise draw comes from
``np.random.default_rng(seed)`` (as the JAX twin's phantoms already do):
the same range [0, noise) and clip to [0, 1], other values. The phantoms'
noise is the JAX twin's own, value for value.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.utils.tensor import resolve_device


def _f32(v: float) -> float:
    """``v`` rounded to fp32, as the twin's ``np.float32(v)`` constants."""
    return float(np.float32(v))


def _axis(size: int, device) -> torch.Tensor:
    """The [-1, 1] lattice coordinates of one axis (fp32)."""
    return torch.from_numpy(np.linspace(-1.0, 1.0, size, dtype=np.float32)).to(device)


def _position_grid(size: int, device) -> torch.Tensor:
    ls = _axis(size, device)
    # meshgrid(..., indexing='xy') swaps the first two axes relative to 'ij'
    # (create_synthetic_volumes.py:55)
    gx, gy, gz = torch.meshgrid(ls, ls, ls, indexing="xy")
    return torch.stack([gx, gy, gz], dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed in index order."""
    sq = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        sq = sq + v[..., i] * v[..., i]
    return torch.sqrt(sq)


def sdf_sphere(pos: torch.Tensor, r: float) -> torch.Tensor:
    """Signed distance to a sphere of radius ``r`` (reference :8-9)."""
    return _norm(pos) - r


def sphere_thickness(pos, r, t):
    """Shell of thickness ``t`` around the sphere surface (reference :11-12)."""
    return (torch.abs(sdf_sphere(pos, r)) < t).float()


def sphere_filled(pos, r):
    """Filled sphere (reference :14-15)."""
    return (sdf_sphere(pos, r) <= 0).float()


def sdf_torus(pos: torch.Tensor, r1: float, r2: float) -> torch.Tensor:
    """Signed distance to a torus (major r1, minor r2) (reference :17-19)."""
    q = _norm(pos[..., :2]) - r1
    return _norm(torch.stack([q, pos[..., 2]], dim=-1)) - r2


def torus_thickness(pos, r1, r2, t):
    return (torch.abs(sdf_torus(pos, r1, r2)) < t).float()


def torus_filled(pos, r1, r2):
    return (sdf_torus(pos, r1, r2) <= 0).float()


def _add_noise(vol: torch.Tensor, rng: np.random.Generator, noise: float, chunk: int) -> None:
    """vol += U[0, 1) · noise, clipped to [0, 1], in place, ``chunk`` planes
    at a time; the draws are the numpy ``Generator``'s, in plane order."""
    size = vol.shape[0]
    for z0 in range(0, size, chunk):
        z1 = min(z0 + chunk, size)
        u = torch.from_numpy(rng.random((z1 - z0,) + tuple(vol.shape[1:])).astype(np.float32))
        vol[z0:z1] = torch.clamp(vol[z0:z1] + u.to(vol.device) * noise, 0.0, 1.0)


def make_synthetic_volumes(
    size: int = 128, noise: float = 0.0, seed: int = 0, device=None
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """The four reference fixtures: sphere/torus × thick/filled.

    Returns {name: (volume fp16, label uint8)} with the shapes, dtypes and
    label rule (vol > 0.5) of create_synthetic_volumes.py:39-69. The noise
    (``noise > 0``) is ``np.random.default_rng(seed)``'s, one draw per
    fixture in this order, not the JAX twin's threefry bits.
    """
    device = resolve_device(device)
    pos = _position_grid(size, device)
    vols = {
        "sphere_thick": sphere_thickness(pos, 0.5, 0.05),
        "sphere_filled": sphere_filled(pos, 0.5),
        "torus_thick": torus_thickness(pos, 0.5, 0.2, 0.05),
        "torus_filled": torus_filled(pos, 0.5, 0.2),
    }
    del pos
    rng = np.random.default_rng(seed)
    out = {}
    for name, vol in vols.items():
        label = (vol > 0.5).to(torch.uint8)
        if noise > 0.0:
            _add_noise(vol, rng, noise, size)
        out[name] = (vol.half(), label)
    return out


def make_multiclass_volume(
    size: int = 128, noise: float = 0.05, seed: int = 0, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-class CT-like synthetic volume with ground-truth labels: three
    disjoint SDF shapes with distinct intensity bands over a noisy
    background (the JAX twin's docstring has the why).

        class 1  filled sphere   intensity ~0.90
        class 2  filled torus    intensity ~0.60
        class 3  sphere shell    intensity ~0.35
        class 0  background      intensity ~noise

    Returns (volume fp32 (size³), labels uint8 (size³)) on ``device``.
    Position axes are independent ('xy' meshgrid: grid[i, j, k] = (ls[j],
    ls[i], ls[k])), so distances are sums of broadcast per-axis squares.
    """
    device = resolve_device(device)
    ls = _axis(size, device)
    vol = torch.zeros((size,) * 3, dtype=torch.float32, device=device)
    labels = torch.zeros((size,) * 3, dtype=torch.uint8, device=device)

    def sq(c, axis):
        d = (ls - _f32(c)) ** 2
        shape = [1, 1, 1]
        shape[axis] = size
        return d.reshape(shape)

    def sphere_d2(c):
        # x = ls[j] (axis 1), y = ls[i] (axis 0), z = ls[k] (axis 2)
        return sq(c[0], 1) + sq(c[1], 0) + sq(c[2], 2)

    m1 = sphere_d2([-0.45, -0.45, -0.35]) <= _f32(0.32**2)
    q = torch.sqrt(sq(0.40, 1) + sq(0.35, 0)) - _f32(0.35)  # (size, size, 1)
    m2 = q * q + sq(0.15, 2) <= _f32(0.13**2)
    d2 = sphere_d2([0.35, -0.45, -0.30])
    m3 = (d2 > _f32((0.28 - 0.07) ** 2)) & (d2 < _f32((0.28 + 0.07) ** 2))
    for i, (mask, intensity) in enumerate([(m1, 0.90), (m2, 0.60), (m3, 0.35)], start=1):
        mask = mask.expand(size, size, size)
        vol[mask] = _f32(intensity)
        labels[mask] = i
    if noise > 0.0:
        _add_noise(vol, np.random.default_rng(seed), noise,
                   max(1, min(size, 2**27 // max(size * size, 1))))
    return vol, labels


def make_hard_phantom(
    size: int = 128, noise: float = 0.05, seed: int = 0, bias: float = 0.12, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anatomy-like hard phantom: nested and touching structures, graded
    contrast, partial-volume boundaries, a smooth multiplicative bias field
    with seed-random phases and additive noise (the JAX twin's docstring
    has the why).

        class 1  body (soft tissue)  I ≈ 0.40 + 0.04·y
        class 2  liver               I ≈ 0.55 + 0.06·x̂ (ramp over extent)
        class 3  kidneys (touching)  I ≈ 0.50
        class 4  bone (spine rod)    I ≈ 0.95  (the one easy class)
        class 5  lesion (in liver)   I ≈ 0.47
        class 0  air background      I ≈ 0.05

    Returns (volume fp32 (size³), labels uint8 (size³)) on ``device``,
    evaluated in y-slabs. Divisions are by 0-dim tensors (IEEE on the card,
    where division by a Python number multiplies by its reciprocal); the
    bias field's cosines may differ from numpy's by an ulp.
    """
    device = resolve_device(device)
    ls = _axis(size, device)
    vol = torch.empty((size,) * 3, dtype=torch.float32, device=device)
    labels = torch.zeros((size,) * 3, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(seed)
    ph = [_f32(v) for v in rng.uniform(0.0, 2.0 * np.pi, 6).astype(np.float32)]
    w = _f32(1.5 * 2.0 / size)  # partial-volume half-width: ~1.5 voxels

    def t(v):  # a 0-dim fp32 divisor on the device
        return torch.tensor(v, dtype=torch.float32, device=device)

    chunk = max(1, min(size, 2**26 // max(size * size, 1)))
    for i0 in range(0, size, chunk):
        i1 = min(i0 + chunk, size)
        # y = ls[i] (axis 0), x = ls[j] (axis 1), z = ls[k] (axis 2)
        y = ls[i0:i1].reshape(-1, 1, 1)
        x = ls.reshape(1, -1, 1)
        z = ls.reshape(1, 1, -1)

        def ellipsoid_sdf(c, r):
            q = torch.sqrt(((x - c[0]) / t(r[0])) ** 2 + ((y - c[1]) / t(r[1])) ** 2
                           + ((z - c[2]) / t(r[2])) ** 2)
            return (q - 1.0) * _f32(min(r))

        def sphere_sdf(c, r):
            return torch.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) - _f32(r)

        structures = [  # (sdf, intensity, label), painted back to front
            (ellipsoid_sdf((0.0, 0.0, 0.0), (0.80, 0.68, 0.88)), 0.40 + 0.04 * y, 1),
            (ellipsoid_sdf((-0.22, -0.08, -0.05), (0.40, 0.30, 0.36)),
             0.55 + 0.06 * (x + 0.22) / t(0.40), 2),
            # kidneys touch the liver surface (y- and z-extremes)
            (torch.minimum(sphere_sdf((-0.22, 0.35, -0.05), 0.15),
                           sphere_sdf((-0.22, -0.08, 0.44), 0.15)), _f32(0.50), 3),
            # spine rod: radial cylinder SDF capped along y
            (torch.maximum(torch.sqrt((x - 0.42) ** 2 + (z - 0.0) ** 2) - _f32(0.10),
                           torch.abs(y) - _f32(0.70)), _f32(0.95), 4),
            # lesion nested inside the liver, ~0.07 below liver intensity
            (sphere_sdf((-0.30, -0.12, -0.10), 0.09), _f32(0.47), 5),
        ]
        slab = torch.full((i1 - i0, size, size), 0.05, dtype=torch.float32, device=device)
        lab_slab = torch.zeros((i1 - i0, size, size), dtype=torch.uint8, device=device)
        for sdf, intensity, lab in structures:
            alpha = torch.clamp(0.5 - sdf / t(2.0 * w), 0.0, 1.0)
            slab = slab * (1.0 - alpha) + intensity * alpha
            lab_slab[(sdf < 0).expand_as(lab_slab)] = lab
        if bias > 0.0:
            b = (1.0 + bias * torch.cos(1.3 * x + ph[0]) * torch.cos(1.1 * y + ph[1])
                 * torch.cos(0.9 * z + ph[2])
                 + 0.5 * bias * torch.cos(2.1 * x + ph[3]) * torch.cos(1.7 * z + ph[4]))
            slab = slab * b
        vol[i0:i1] = slab
        labels[i0:i1] = lab_slab
    if noise > 0.0:
        _add_noise(vol, rng, noise, chunk)
    return vol, labels


PHANTOMS = {
    "easy": make_multiclass_volume,
    "hard": make_hard_phantom,
}


def write_synthetic_volumes(
    outdir: str | Path, size: int = 128, noise: float = 0.0, use_pt: bool = False,
    device=None,
) -> list[Path]:
    """CLI-equivalent of the reference generator: writes ``{name}.npy`` +
    ``{name}_label.npy`` (or ``.pt``) into ``outdir``."""
    from vittf_tpu_torch.core.io import save_array

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = ".pt" if use_pt else ".npy"
    written = []
    for name, (vol, label) in make_synthetic_volumes(size, noise, device=device).items():
        written.append(save_array(outdir / f"{name}{suffix}", vol))
        written.append(save_array(outdir / f"{name}_label{suffix}", label))
    return written
