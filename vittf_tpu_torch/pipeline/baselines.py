"""SVM / Random-Forest per-voxel baselines (reference predict_svm_rf.py).

Port of ``vittf_tpu/pipeline/baselines.py``. Feature composition runs in
PyTorch on the device; the classifiers stay sklearn on the CPU exactly like
the reference (libsvm/RF serve only as evaluation baselines), except the
dense SVC prediction, which ``svm_predict_device`` evaluates on the device.
Semantics preserved:

- 11-dim hand-crafted features: intensity/max, central-difference gradient
  magnitude, 6 replicate-padded neighbors, normalized coords − 0.5, all
  standardized per channel (predict_svm_rf.py:25-65)
- training labels are the *index in sorted class-name order* (the
  reference's labels branch is dead code behind ``if False``,
  predict_svm_rf.py:176-179 → sample_train_data labels = class index)
- background class sampled with as many samples as the largest class, from
  labels==0 or from a 4-voxel border shell (predict_svm_rf.py:151-158)
- SVC(kernel='rbf') and RandomForestClassifier(n_estimators=1024,
  max_features=None), dense prediction over every voxel, metrics JSON in
  the reference layout with fit/predict timings
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from vittf_tpu_torch.ops.morphology import filter_sobel_separated
from vittf_tpu_torch.ops.sampling import sample_features3d
from vittf_tpu_torch.pipeline.evaluate import segmentation_metrics
from vittf_tpu_torch.utils.tensor import ieee_matmul, make_4d, make_5d, resolve_device


def get_neighbors6(volume4: torch.Tensor) -> torch.Tensor:
    """(1, W, H, D) → (6, W, H, D) intensities of the 6 face neighbors,
    replicate-padded (predict_svm_rf.py:39-48; order +w, +h, +d, −w, −h, −d)."""
    p = F.pad(volume4[None], (1, 1, 1, 1, 1, 1), mode="replicate")[0]
    return torch.cat(
        [
            p[:, 2:, 1:-1, 1:-1],
            p[:, 1:-1, 2:, 1:-1],
            p[:, 1:-1, 1:-1, 2:],
            p[:, :-2, 1:-1, 1:-1],
            p[:, 1:-1, :-2, 1:-1],
            p[:, 1:-1, 1:-1, :-2],
        ],
        dim=0,
    )


def compose_features(volume: torch.Tensor) -> torch.Tensor:
    """11-dim per-voxel features, standardized (predict_svm_rf.py:53-65);
    (11, W, H, D) fp32 on the volume's device."""
    volume = torch.as_tensor(volume).float()
    shape = tuple(volume.shape)
    vmax = volume.max()
    intensity = make_4d(volume) / vmax
    grad_mag = filter_sobel_separated(make_5d(volume) / vmax).reshape((1,) + shape)
    neighbors = get_neighbors6(intensity)
    grids = torch.meshgrid(
        *(torch.arange(s, device=volume.device) for s in shape), indexing="ij"
    )
    coords = torch.stack(grids).float()
    extent = torch.tensor(shape, dtype=torch.float32, device=volume.device)
    coords = coords / extent[:, None, None, None] - 0.5
    feats = torch.cat([intensity, grad_mag, neighbors, coords], dim=0)
    mean = feats.mean(dim=(-1, -2, -3), keepdim=True)
    std = feats.std(dim=(-1, -2, -3), keepdim=True, correction=1)
    return (feats - mean) / std


def sample_train_data(
    features: torch.Tensor, annotations: dict[str, np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """(N, F) features + (N,) class-index labels at annotation voxels.

    Classes are iterated in sorted name order; nearest-sampled from the
    feature grid (predict_svm_rf.py:67-92).
    """
    xs, ys = [], []
    feat_shape = torch.tensor(
        tuple(features.shape[-3:]), dtype=torch.float32, device=features.device
    )
    for i, name in enumerate(sorted(annotations.keys())):
        ann = torch.as_tensor(
            np.asarray(annotations[name]), dtype=torch.float32, device=features.device
        )
        rel = (ann + 0.5) / feat_shape * 2.0 - 1.0
        sampled = sample_features3d(features, rel, mode="nearest")[0, 0]
        xs.append(sampled.cpu().numpy())
        ys.append(np.full(ann.shape[0], i, np.uint8))
    return np.concatenate(xs), np.concatenate(ys)


def sample_background_border(vol_shape, border: int = 4) -> np.ndarray:
    """Border-shell mask for background sampling when no labels exist
    (predict_svm_rf.py:155-158)."""
    m = np.ones(vol_shape, bool)
    m[border:-border, border:-border, border:-border] = False
    return m


def fit_predict_classifier(
    clf,
    train_X: np.ndarray,
    train_y: np.ndarray,
    features_flat,
    device_predict: bool = False,
):
    """Fit + dense predict with the reference's timing capture.

    ``device_predict`` routes the dense SVC prediction through the device
    decision-function evaluation (``svm_predict_device``, on the device where
    the ``features_flat`` tensor lies); fit stays
    sklearn/libsvm (seconds — the reference's pathology is the dense
    predict, not the fit).
    """
    t0 = time.time()
    clf.fit(train_X, train_y)
    t1 = time.time()
    if device_predict:
        pred = svm_predict_device(clf, features_flat)  # ends on the host
    else:
        if torch.is_tensor(features_flat):
            features_flat = features_flat.cpu().numpy()
        pred = clf.predict(features_flat)
    t2 = time.time()
    return pred, {"fit_time": t1 - t0, "predict_time": t2 - t1}


def _build_ovo_weights(clf) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """libsvm one-vs-one decision as a single (S, n_pairs) matrix.

    For the pair (i, j), i<j, the decision is a linear functional of the
    kernel row K(x, ·): support vectors of class i contribute their
    ``dual_coef_[j-1]`` entries, those of class j their ``dual_coef_[i]``
    entries (sklearn's compressed OvO layout), plus ``intercept_``.
    Returns (W, b, pair_i, pair_j) with pairs in libsvm/intercept_ order
    (0,1), (0,2), …, (1,2), …
    """
    k = len(clf.classes_)
    n_sv = clf.support_vectors_.shape[0]
    starts = np.concatenate([[0], np.cumsum(clf.n_support_)])
    n_pairs = k * (k - 1) // 2
    W = np.zeros((n_sv, n_pairs), np.float32)
    pair_i = np.empty(n_pairs, np.int32)
    pair_j = np.empty(n_pairs, np.int32)
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            W[starts[i] : starts[i + 1], p] = clf.dual_coef_[
                j - 1, starts[i] : starts[i + 1]
            ]
            W[starts[j] : starts[j + 1], p] = clf.dual_coef_[
                i, starts[j] : starts[j + 1]
            ]
            pair_i[p], pair_j[p] = i, j
            p += 1
    return W, clf.intercept_.astype(np.float32), pair_i, pair_j


def _resolve_gamma(clf) -> float:
    """RBF gamma from the fitted classifier, failing loudly.

    libsvm's effective gamma lives in the private ``_gamma``; if sklearn
    ever renames it, fall back to the public ``gamma`` semantics
    ('auto' = 1/n_features, numeric = itself). 'scale' depends on the
    training data's variance, which sklearn does not retain — raise
    instead of silently predicting with exp(0)=1 kernels (a constant
    single-class collapse)."""
    g = getattr(clf, "_gamma", None)
    if g is not None:
        return float(g)
    if isinstance(clf.gamma, (int, float)):
        return float(clf.gamma)
    if clf.gamma == "auto":
        return 1.0 / clf.n_features_in_
    raise AttributeError(
        "cannot resolve the fitted RBF gamma: clf._gamma is missing and "
        f"gamma={clf.gamma!r} depends on training-data statistics"
    )


def _svm_votes_device(xc, sv, sv_sq, W, b, pair_i, pair_j, gamma, kernel, n_classes):
    """One (chunk, F) tile: kernel tile → OvO decisions → votes → argmax,
    uint8 class indices.

    Both matmuls run in IEEE fp32 (the caller holds TF32 off): RBF distances
    cancel, and lose catastrophic relative precision in fewer bits.
    """
    xs = xc @ sv.T
    if kernel == "rbf":
        d2 = (xc * xc).sum(-1)[:, None] - 2.0 * xs + sv_sq[None, :]
        K = torch.exp(-gamma * d2.clamp_min(0.0))
    else:  # linear
        K = xs
    D = K @ W + b[None, :]
    winners = torch.where(D > 0, pair_i[None, :], pair_j[None, :])
    votes = F.one_hot(winners, n_classes).sum(1)
    # libsvm breaks vote ties toward the lowest class index; argmax returns
    # the first maximal index
    return torch.argmax(votes, dim=-1).to(torch.uint8)


def svm_predict_device(
    clf, features_flat, chunk: int = 1 << 16, device=None
) -> np.ndarray:
    """Dense SVC prediction on the device — the reference's dense CPU
    predict (predict_svm_rf.py:209-212) over (chunk, n_SV) kernel tiles.

    Reproduces libsvm's one-vs-one vote exactly (up to fp32 vs float64 in
    decision values; vote flips require a decision within ~1e-5 of zero).
    Supports kernel='rbf' (reference default) and 'linear'.

    ``features_flat`` (N, F): a tensor is evaluated where it lies; a numpy
    array stays in host memory and is streamed to ``device`` (the first CUDA
    device when None) one chunk at a time, so that the full (N, F) fp32
    matrix never lies in device memory (≈6 GB at 512³). Returns the (N,)
    predicted classes as a numpy array.
    """
    kernel = clf.kernel
    if kernel not in ("rbf", "linear"):
        raise ValueError(f"device predict supports rbf/linear, got {kernel}")
    W, b, pair_i, pair_j = _build_ovo_weights(clf)
    n = features_flat.shape[0]
    # keep the (chunk, n_SV) fp32 kernel tile under ~1 GB of device memory
    tile_cap = (1 << 30) // max(1, 4 * clf.support_vectors_.shape[0])
    chunk = max(1024, min(chunk, tile_cap))
    chunk = 1 << (chunk.bit_length() - 1)
    resident = torch.is_tensor(features_flat)
    device = features_flat.device if resident else resolve_device(device)
    sv = torch.as_tensor(np.asarray(clf.support_vectors_, np.float32), device=device)
    common = (
        sv, (sv * sv).sum(-1),
        torch.as_tensor(W, device=device), torch.as_tensor(b, device=device),
        torch.as_tensor(pair_i, device=device).long(),
        torch.as_tensor(pair_j, device=device).long(),
        float(np.float32(_resolve_gamma(clf) if kernel == "rbf" else 0.0)),
        kernel, len(clf.classes_),
    )
    if not resident:
        features_flat = torch.from_numpy(np.ascontiguousarray(features_flat, np.float32))
    out = torch.empty(n, dtype=torch.uint8, device=device)
    with ieee_matmul():
        for i in range(0, n, chunk):
            xc = features_flat[i : i + chunk].to(device=device, dtype=torch.float32)
            out[i : i + chunk] = _svm_votes_device(xc, *common)
    return np.asarray(clf.classes_)[out.cpu().numpy()]


def run_svm_rf(
    volume,
    annotations: dict[str, np.ndarray],
    labels: np.ndarray | None = None,
    features=None,
    svm_kernel: str = "rbf",
    run_svm: bool = True,
    run_rf: bool = True,
    rf_estimators: int = 1024,
    exclude_bg: bool = False,
    device_predict: bool = False,
    device=None,
) -> dict[str, dict]:
    """Train + densely evaluate the SVM/RF baselines.

    ``features`` defaults to the 11-dim composed features of ``volume``;
    pass DINO features (F, W', H', D') for the --use-dino-features mode
    (labels are then nearest-resized to the feature grid by the caller).
    Feature composition, training-data sampling and the device SVM predict
    run on ``device`` (the first CUDA device when None).

    ``exclude_bg``: the reference's --exclude-bg mode
    (predict_svm_rf.py:192-229): only non-background voxels are predicted
    and scored, GT labels shift down by 1, background voxels in the dense
    prediction volume stay 0.
    """
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.svm import SVC

    device = resolve_device(device)
    if features is None:
        features = compose_features(torch.as_tensor(np.ascontiguousarray(volume)).to(device))
    features = torch.as_tensor(features).to(device)
    train_X, train_y = sample_train_data(features, annotations)
    feat_size = tuple(features.shape[-3:])
    features_flat = torch.movedim(features, 0, -1).reshape(-1, features.shape[0])
    keys = sorted(annotations.keys())

    eval_labels = None if labels is None else np.asarray(labels).reshape(-1)
    non_bg = None
    if exclude_bg:
        if eval_labels is None:
            raise ValueError("exclude_bg requires labels")
        non_bg = eval_labels != 0
        features_flat = features_flat[torch.from_numpy(non_bg).to(device)]
        eval_labels = eval_labels[non_bg] - 1

    results = {}
    jobs = []
    if run_svm:
        jobs.append(("svm", SVC(kernel=svm_kernel)))
    if run_rf:
        jobs.append(
            ("rf", RandomForestClassifier(n_estimators=rf_estimators, max_features=None))
        )
    for name, clf in jobs:
        on_device = (
            device_predict and name == "svm" and svm_kernel in ("rbf", "linear")
        )
        pred, times = fit_predict_classifier(
            clf, train_X, train_y, features_flat, device_predict=on_device
        )
        if exclude_bg:
            predv = np.zeros(int(np.prod(feat_size)), np.uint8)
            predv[non_bg] = pred
            predv = predv.reshape(feat_size)
        else:
            predv = pred.reshape(feat_size).astype(np.uint8)
        entry = {"pred": predv, **times}
        if eval_labels is not None:
            entry["metrics"] = segmentation_metrics(
                eval_labels, pred, keys, extra=times
            )
        results[name] = entry
    return results
