"""Volume format conversion tools (reference ``conversion/`` directory).

One module replaces the reference's seven per-format scripts, with proper
parameterization instead of hardcoded paths. Optional readers (pydicom /
tifffile / nibabel) are imported lazily and gated — each converter raises a
clear error naming the missing dependency.

Port of ``vittf_tpu/convert/volumes.py``. Resizing runs through the
package's resize ops on ``device`` (the first CUDA device when None; the
other converters are host-only file work).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.ops.resize import resize_linear, resize_nearest
from vittf_tpu_torch.utils.tensor import make_5d, resolve_device


def _require(modname: str):
    try:
        return __import__(modname)
    except ImportError as e:
        raise ImportError(
            f"{modname} is required for this converter (not installed)"
        ) from e


def dcm_to_npy(dcm_dir: str | Path, out_path: str | Path,
               save_nifti: bool = False) -> np.ndarray:
    """Stack DICOM slices (sorted by filename) along the last axis
    (conversion/dcm2npy.py semantics)."""
    dcm = _require("pydicom")
    dcm_dir = Path(dcm_dir)
    arrays = []
    for fn in sorted(dcm_dir.iterdir()):
        ds = dcm.dcmread(fn)
        if hasattr(ds, "pixel_array"):
            arrays.append(ds.pixel_array)
    vol = np.stack(arrays, axis=-1)
    np.save(out_path, vol)
    if save_nifti:
        nb = _require("nibabel")
        nb.save(nb.Nifti1Image(vol, np.eye(4)),
                str(Path(out_path).with_suffix(".nii.gz")))
    return vol


def tiff_to_npy(tiff_dir: str | Path, out_path: str | Path) -> np.ndarray:
    """Stack ``*.tif`` slices (sorted) along the last axis
    (conversion/tiff2npy.py semantics)."""
    tifffile = _require("tifffile")
    tiff_dir = Path(tiff_dir)
    slices = [tifffile.imread(f) for f in sorted(tiff_dir.rglob("*.tif"))]
    if not slices:
        raise FileNotFoundError(f"No tiffs found in {tiff_dir}")
    vol = np.stack(slices, axis=-1)
    np.save(out_path, vol)
    return vol


def nifti_to_npy(
    nii_path: str | Path, out_path: str | Path | None = None
) -> np.ndarray:
    """NIfTI volume → npy (the notebooks/convert_nifti.ipynb capability)."""
    nb = _require("nibabel")
    nii_path = Path(nii_path)
    vol = np.asanyarray(nb.load(str(nii_path)).dataobj)
    if out_path is None:
        out_path = nii_path.with_suffix("").with_suffix(".npy")
    np.save(out_path, vol)
    return vol


def raw_to_npy(
    raw_path: str | Path,
    shape: tuple[int, ...],
    dtype: str = "uint8",
    out_path: str | Path | None = None,
    channels_last: bool = True,
) -> np.ndarray:
    """Read a headerless ``.raw`` volume with the given shape
    (conversion/raw2npy.py semantics, shape as a parameter instead of
    hardcoded). A sibling ``.dat`` header file is printed if present."""
    raw_path = Path(raw_path)
    dat_path = raw_path.with_suffix(".dat")
    if dat_path.exists():
        print(f"DAT file:\n{dat_path.read_text()}")
    arr = np.fromfile(raw_path, dtype=np.dtype(dtype), count=int(np.prod(shape)))
    vol = arr.reshape(shape)
    if not channels_last and vol.ndim == 4:
        vol = np.moveaxis(vol, 0, -1)
    if out_path is None:
        out_path = raw_path.with_suffix(".npy")
    np.save(out_path, np.ascontiguousarray(vol))
    return vol


def resize_volume(
    in_path: str | Path,
    resolution: tuple[float, float, float],
    out_path: str | Path | None = None,
    device=None,
) -> np.ndarray:
    """Trilinear resize; values > 1 are absolute sizes, ≤ 1 are fractions
    (conversion/resize.py semantics)."""
    in_path = Path(in_path)
    data = np.load(in_path).astype(np.float32)
    res = tuple(
        int(r) if r > 1.0 else int(r * data.shape[i])
        for i, r in enumerate(resolution)
    )
    data_t = torch.from_numpy(data).to(resolve_device(device))
    out = resize_linear(make_5d(data_t), res).reshape(res).cpu().numpy()
    if out_path is None:
        out_path = in_path.parent / f"{in_path.stem}_resized{in_path.suffix}"
    np.save(out_path, out)
    return out


def downsample_z(
    in_path: str | Path, factor: int = 2, out_path: str | Path | None = None,
    device=None,
) -> np.ndarray:
    """Nearest-downsample the (largest) Z axis by ``factor``
    (conversion/halfZ.py / quaterZ.py semantics; factor 2 or 4)."""
    in_path = Path(in_path)
    vol = np.load(in_path, allow_pickle=True)
    if vol.dtype == "O":
        vol = vol[()]
    assert vol.ndim == 3
    assert vol.shape[2] > vol.shape[0] and vol.shape[2] > vol.shape[1]
    size = (vol.shape[0], vol.shape[1], vol.shape[2] // factor)
    vol_t = torch.from_numpy(vol.astype(np.float32)).to(resolve_device(device))
    out = resize_nearest(make_5d(vol_t), size).reshape(size).cpu().numpy().astype(vol.dtype)
    if out_path is None:
        tag = {2: "_halfZ", 4: "_quaterZ"}.get(factor, f"_z{factor}")
        out_path = str(in_path).replace(".npy", f"{tag}.npy")
    np.save(out_path, out)
    return out
