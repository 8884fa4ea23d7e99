"""Segmentation metrics (sklearn-parity), computed on the labels' device,
and the user-study evaluator.

Port of ``vittf_tpu/pipeline/evaluate.py`` (predict_ntf.py:228-246,
evaluate_similarities.py:37-83): accuracy and per-class precision / recall / F1 /
IoU from a confusion matrix, with sklearn's ``average=None`` and
zero-division→0 semantics over the label set ``0..num_classes-1``. The
matrix is a ``bincount`` of ``true·C + pred`` (exact integer counts); the
metrics are fp32, as in the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.ops.resize import resize_nearest
from vittf_tpu_torch.utils.tensor import resolve_device

# CT-ORG label map (evaluate_similarities.py:27-35)
LABEL2IDX = {
    "background": 0,
    "liver": 1,
    "bladder": 2,
    "lung": 3,
    "kidney": 4,
    "bone": 5,
}
IDX2LABEL = ["liver", "bladder", "lung", "kidney", "bone"]


def confusion_matrix(
    y_true: torch.Tensor, y_pred: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """(C, C) int64 counts, rows = true class, cols = predicted (sklearn layout)."""
    idx = y_true.reshape(-1).to(torch.int64) * num_classes + y_pred.reshape(-1).to(torch.int64)
    counts = torch.bincount(idx, minlength=num_classes**2)[: num_classes**2]
    return counts.reshape(num_classes, num_classes)


def metrics_from_confusion(cm: torch.Tensor) -> dict[str, torch.Tensor]:
    """accuracy + per-class precision/recall/F1/IoU; zero denominators → 0."""
    cm = cm.to(torch.float32)
    tp = torch.diagonal(cm)
    pred_tot = cm.sum(dim=0)
    true_tot = cm.sum(dim=1)

    def safe_div(a, b):
        return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)), torch.zeros_like(a))

    precision = safe_div(tp, pred_tot)
    recall = safe_div(tp, true_tot)
    f1 = safe_div(2 * precision * recall, precision + recall)
    iou = safe_div(tp, pred_tot + true_tot - tp)
    accuracy = safe_div(tp.sum(), cm.sum())
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "iou": iou,
    }


def segmentation_metrics(
    y_true, y_pred, label_names: list[str], extra: dict | None = None
) -> dict:
    """Metrics JSON in the reference's layout (predict_ntf.py:233-246).

    Tensors stay on their device for the confusion count; only the (C, C)
    matrix and the metric vectors come back to the host."""

    def flat(x):
        if isinstance(x, torch.Tensor):
            return x.reshape(-1)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x).reshape(-1)))

    y_true = flat(y_true)
    y_pred = flat(y_pred).to(y_true.device)
    C = len(label_names)
    cm = confusion_matrix(y_true, y_pred, C)
    m = {k: v.cpu().numpy() for k, v in metrics_from_confusion(cm).items()}
    out = {
        "mAcc": float(m["accuracy"]),
        "precision": dict(zip(label_names, m["precision"].tolist())),
        "mPrec": float(m["precision"].mean()),
        "recall": dict(zip(label_names, m["recall"].tolist())),
        "mRec": float(m["recall"].mean()),
        "f1": dict(zip(label_names, m["f1"].tolist())),
        "mF1": float(m["f1"].mean()),
        "iou": dict(zip(label_names, m["iou"].tolist())),
        "mIoU": float(m["iou"].mean()),
        "confusion_matrix": dict(zip(label_names, cm.cpu().numpy().tolist())),
    }
    if extra:
        out.update(extra)
    return out


def evaluate_user_study(
    data_dir: str | Path,
    label_path: str | Path,
    label_names: list[str] = ("lung", "liver", "kidney"),
    device=None,
) -> dict:
    """GUI-session evaluator (evaluate_similarities.py:37-83).

    Loads exported ``predictions.npy`` (binary per-class volumes keyed by
    class) + ``metadata.json`` (annotation time/count), nearest-resizes the
    GT label volume to each prediction's resolution, and writes per-class
    binary metrics to ``metrics.json``. The resize and the confusion counts
    run on ``device`` (the first CUDA device when None).
    """
    device = resolve_device(device)
    data_dir = Path(data_dir)
    with open(data_dir / "metadata.json", encoding="UTF-8") as f:
        metadata = json.load(f)
    labels_data = np.load(label_path, allow_pickle=True)
    labels_orig = labels_data[()] if labels_data.dtype == "O" else labels_data
    labels_t = torch.as_tensor(np.ascontiguousarray(labels_orig)).to(device)
    preds = np.load(data_dir / "predictions.npy", allow_pickle=True)[()]

    results = {}
    for ln, k in zip(label_names, sorted(preds.keys())):
        p = torch.as_tensor(np.ascontiguousarray(preds[k])).to(device)
        meta = metadata[k]
        gt = (labels_t == LABEL2IDX[ln]).to(torch.uint8)
        gt = resize_nearest(gt, tuple(p.shape[-3:]))
        cm = confusion_matrix(gt, p, 2)
        m = {name: v.cpu().numpy() for name, v in metrics_from_confusion(cm).items()}
        results[ln] = {
            "accuracy": float(m["accuracy"]),
            "precision": m["precision"].tolist(),
            "recall": m["recall"].tolist(),
            "f1": m["f1"].tolist(),
            "iou": m["iou"].tolist(),
            "confusion_matrix": cm.cpu().numpy().tolist(),
            "annotation_time": meta["time"],
            "num_annotations": meta["num_annotations"],
        }
    with open(data_dir / "metrics.json", "w") as f:
        json.dump(results, f)
    return results
