"""Segmentation metrics (sklearn-parity), computed on the labels' device.

Port of the metric part of ``vittf_tpu/pipeline/evaluate.py``
(predict_ntf.py:228-246): accuracy and per-class precision / recall / F1 /
IoU from a confusion matrix, with sklearn's ``average=None`` and
zero-division→0 semantics over the label set ``0..num_classes-1``. The
matrix is a ``bincount`` of ``true·C + pred`` (exact integer counts); the
metrics are fp32, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

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
