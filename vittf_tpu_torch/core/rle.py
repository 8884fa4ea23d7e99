"""Run-length-encoded annotation codec.

The reference's semisparse trainer variant imports
``from rle_shit import decode_from_annotation``
(``old/train_semisparse_old.py:14``) — an external module
whose source is not in the repo. The capability it names is standard: GUI
annotation exports arrive as per-class run-length encodings over the
flattened label volume (the usual medical-imaging export format), and the
trainer needs them back as per-class voxel coordinate arrays.

This module supplies both directions with the conventional semantics:

- runs are ``[start, length, start, length, ...]`` pairs over the volume
  flattened in C order (z-major for a (Z, Y, X) volume);
- an annotation is ``{class_name: runs}``;
- decode returns ``{class_name: (N, 3) int32 voxel coordinates}``, the
  same shape contract as ``annotations.npy`` in the artifact pipeline
  (reference predict_ntf.py:154).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "encode_to_annotation",
    "decode_from_annotation",
    "decode_rle_mask",
]


def encode_to_annotation(
    labels: np.ndarray, label_names: dict[int, str] | None = None,
    include_background: bool = False,
) -> dict[str, np.ndarray]:
    """Encode an integer label volume as per-class RLE runs.

    Args:
        labels: (Z, Y, X) integer label volume.
        label_names: optional {index: name}; defaults to ``str(index)``.
        include_background: also encode class 0 (off by default — the
            background class is implicit in the trainer's sampling).

    Returns:
        {class_name: int64 array [start0, len0, start1, len1, ...]} over
        the C-order-flattened volume.
    """
    labels = np.asarray(labels)
    flat = labels.reshape(-1)
    out: dict[str, np.ndarray] = {}
    for c in np.unique(flat):
        c = int(c)
        if c == 0 and not include_background:
            continue
        mask = flat == c
        # starts where the mask turns on, ends where it turns off
        turn = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
        run_starts = np.flatnonzero(turn == 1)
        run_ends = np.flatnonzero(turn == -1)
        runs = np.empty(2 * run_starts.size, dtype=np.int64)
        runs[0::2] = run_starts
        runs[1::2] = run_ends - run_starts
        name = label_names[c] if label_names else str(c)
        out[name] = runs
    return out


def decode_rle_mask(runs: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Decode one class's runs to a boolean mask of ``shape``."""
    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 2)
    size = int(np.prod(shape))
    mask = np.zeros(size, dtype=bool)
    for start, length in runs:
        if start < 0 or start + length > size:
            raise ValueError(
                f"run [{start}, {length}) exceeds volume of {size} voxels"
            )
        mask[start : start + length] = True
    return mask.reshape(shape)


def decode_from_annotation(
    annotation: dict[str, np.ndarray], shape: tuple[int, ...]
) -> dict[str, np.ndarray]:
    """Decode an RLE annotation dict to per-class (N, 3) voxel coordinates.

    Same symbol name as the reference's external dependency
    (old/train_semisparse_old.py:14) so call sites read identically.
    """
    out: dict[str, np.ndarray] = {}
    for name, runs in annotation.items():
        mask = decode_rle_mask(runs, shape)
        out[name] = np.argwhere(mask).astype(np.int32)
    return out
