"""Fast-mode and refinement quality experiments on labeled phantoms.

Port of ``vittf_tpu/pipeline/quality.py``: the full NTF pipeline (features →
similarity → fuse → IoU) on a labeled synthetic phantom with identical
annotations under both extraction modes (full sweep vs slice subsample), on
a trained CNN oracle's features (the structured A/B), and with and without
the refinement stack (bilateral solver, largest island). The JAX module's
docstrings have the why of each experiment.

Every experiment runs on ``device`` (the first CUDA device when None;
``device='cpu'`` on the CPU): the phantom is made there, annotations are
drawn there and the prediction stays there for scoring. On a CUDA device
the extraction runs the attention kernel (or the fused block with
``block_impl='fused'``), every similarity the similarity kernel, and the
refinement's solver the splat, slice and blur kernels.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
from vittf_tpu_torch.pipeline.evaluate import segmentation_metrics
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
from vittf_tpu_torch.pipeline.ntf import (
    compute_similarities,
    fuse_predictions,
    upscale_prediction,
)
from vittf_tpu_torch.utils.tensor import resolve_device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ntf_predict(
    vol,
    params: dict,
    model_cfg,
    ex_cfg: ExtractConfig,
    annotations: dict[str, np.ndarray],
    fuse_thresholds: list[float] | None = None,
    device=None,
) -> tuple[torch.Tensor, dict[str, float]]:
    """Features → similarities → fused label volume, with stage timings.

    Returns (pred labels at full volume resolution, a tensor on ``device``,
    {stage: seconds}). Each stage runs once to warm up, then once timed,
    fenced by ``torch.cuda.synchronize`` on a CUDA device.
    """
    device = resolve_device(device)
    vol_t = torch.as_tensor(vol, dtype=torch.float32).to(device)

    def timed(fn):
        fn()
        _synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        _synchronize(device)
        return out, time.perf_counter() - t0

    feats, t_extract = timed(
        lambda: extract_features(vol_t, params, model_cfg, ex_cfg, device=device)["k"])
    sims, t_sim = timed(lambda: compute_similarities(vol_t, feats, annotations))
    thresholds = fuse_thresholds if fuse_thresholds is not None else [0.25] * len(sims)
    pred = fuse_predictions(sims, thresholds)
    # stays on the device: scoring runs there too
    pred = upscale_prediction(pred, tuple(vol_t.shape))
    return pred, {"extract_s": t_extract, "similarity_s": t_sim}


def _sample_background(
    labels: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniform background voxels by rejection sampling (host numpy, the JAX
    twin's draws)."""
    out: list[np.ndarray] = []
    got = 0
    while got < n:
        cand = np.stack(
            [rng.integers(0, s, 4 * n) for s in labels.shape], axis=1
        )
        keep = cand[labels[cand[:, 0], cand[:, 1], cand[:, 2]] == 0]
        out.append(keep[: n - got])
        got += len(out[-1])
    return np.concatenate(out)


def _phantom_annotations(labels: torch.Tensor, n_annotations: int, seed: int):
    """Per-class annotations, then an explicit background class LAST
    ('bg'): returns (annotations, number of foreground classes)."""
    rng = np.random.default_rng(seed)
    annotations = annotations_from_labels(labels, n_annotations, "both", rng=rng,
                                          device=labels.device)
    n_fg = len(annotations)
    annotations["bg"] = _sample_background(labels.cpu().numpy(), n_annotations, rng)
    return annotations, n_fg


def _score(labels, pred, names, n_fg) -> dict:
    """Foreground IoU table of a prediction whose background class (the
    last, ``n_fg + 1``) is relabeled 0."""
    pred = torch.where(pred == n_fg + 1, torch.zeros_like(pred), pred)
    m = segmentation_metrics(labels, pred, names)
    fg_iou = {k: v for k, v in m["iou"].items() if k != "background"}
    return {
        "mIoU_fg": float(np.mean(list(fg_iou.values()))),
        "iou": fg_iou,
        "accuracy": m["mAcc"],
    }


def fastmode_quality_experiment(
    size: int,
    params: dict,
    model_cfg,
    base_cfg: ExtractConfig,
    n_annotations: int = 256,
    seed: int = 0,
    phantom: str = "easy",
    device=None,
) -> dict:
    """Run full-sweep vs fast-mode NTF on the multi-class phantom.

    Returns {mode: {"mIoU_fg", "iou", "accuracy", "extract_s",
    "similarity_s", "mvoxel_s"}} plus the shared experiment metadata.
    Identical annotations are used for both modes. ``phantom`` picks the
    fixture family (core/synthetic.py PHANTOMS).
    """
    from vittf_tpu_torch.core.synthetic import PHANTOMS

    device = resolve_device(device)
    vol, labels = PHANTOMS[phantom](size, seed=seed, device=device)
    annotations, n_fg = _phantom_annotations(labels, n_annotations, seed)
    names = ["background"] + [k for k in annotations if k != "bg"]

    out: dict = {
        "size": size,
        "n_annotations": n_annotations,
        "phantom": phantom,
        "classes": [k for k in annotations if k != "bg"],
    }
    for mode, cfg in [
        ("full", replace(base_cfg, slice_subsample=False)),
        ("fast", replace(base_cfg, slice_subsample=True)),
    ]:
        pred, times = ntf_predict(vol, params, model_cfg, cfg, annotations, device=device)
        total_s = times["extract_s"] + times["similarity_s"]
        out[mode] = {
            **_score(labels, pred, names, n_fg),
            **times,
            "mvoxel_s": size**3 / total_s / 1e6,
        }
    out["iou_delta"] = out["full"]["mIoU_fg"] - out["fast"]["mIoU_fg"]
    out["speedup"] = out["full"]["extract_s"] / out["fast"]["extract_s"]
    return out


def _predict_and_score(vol, feats, annotations, labels, names, n_fg):
    """similarity → fuse → upscale → metrics for a given feature volume."""
    sims = compute_similarities(vol, feats, annotations)
    pred = fuse_predictions(sims, [0.25] * len(sims))
    pred = upscale_prediction(pred, tuple(vol.shape))  # device-resident
    return _score(labels, pred, names, n_fg)


def grid_ceiling_miou(labels, fos: int, device=None) -> dict:
    """mIoU of the IDEAL predictor at an fos³ output grid: the ground truth
    majority-pooled to the similarity grid (on the host) and upscaled back
    (on ``device``)."""
    device = resolve_device(device)
    labels = labels.cpu().numpy() if torch.is_tensor(labels) else np.asarray(labels)
    size = labels.shape[0]
    fos = min(fos, size)
    f = size // fos
    # non-divisible sizes: pool over the largest covered f·fos³ corner
    lab = labels[: f * fos, : f * fos, : f * fos]
    lab = lab.reshape(fos, f, fos, f, fos, f)
    n_cls = int(labels.max()) + 1
    counts = np.stack([(lab == c).sum(axis=(1, 3, 5)) for c in range(n_cls)])
    grid_pred = counts.argmax(axis=0).astype(np.uint8)
    up = upscale_prediction(torch.from_numpy(grid_pred).to(device), labels.shape)
    names = ["background"] + [f"c{i}" for i in range(1, n_cls)]
    m = segmentation_metrics(torch.from_numpy(labels).to(device), up, names)
    fg = {k: v for k, v in m["iou"].items() if k != "background"}
    return {"mIoU_fg": float(np.mean(list(fg.values()))), "iou": fg}


def _train_cnn_oracle_features(
    vol,
    labels,
    names: list[str],
    size: int,
    seed: int,
    train_iterations: int,
    model_features: tuple,
    model_linear: tuple,
    pos_encoding: bool,
    learning_rate: float,
    samples_per_iteration: int,
    temperature: float,
    train_size: int | None,
    phantom: str = "easy",
    device=None,
):
    """Train the dense-contrastive CNN oracle and return its unit-norm
    full-resolution (F, Z, Y, X) feature volume for the EVAL volume, the last
    train record and the train size."""
    from vittf_tpu_torch.core.synthetic import PHANTOMS
    from vittf_tpu_torch.models.cnn3d import FeatureExtractorConfig
    from vittf_tpu_torch.train.dense import DenseContrastiveConfig, DenseContrastiveTrainer

    device = resolve_device(device)
    n_classes = int(labels.max())
    tsize = train_size or size
    if tsize != size:
        tvol, tlabels = PHANTOMS[phantom](tsize, seed=seed, device=device)
        assert int(tlabels.max()) == n_classes
    else:
        tvol, tlabels = vol, labels

    tcfg = DenseContrastiveConfig(
        model=FeatureExtractorConfig(
            n_features=tuple(model_features), n_linear=tuple(model_linear)
        ),
        pos_encoding=pos_encoding,
        learning_rate=learning_rate,
        temperature=temperature,
        iterations=train_iterations,
        samples_per_iteration=samples_per_iteration,
        neg_count=min(1024, tsize**2),
    )
    trainer = DenseContrastiveTrainer(tvol, tlabels.cpu().numpy(), names, tcfg, seed=seed,
                                      device=device)
    rec = {"loss": float("nan")}  # train_iterations=0 = untrained baseline
    for _ in range(train_iterations):
        rec = trainer.step()
    # (F, Z, Y, X) features of the EVAL volume at full resolution
    feats = trainer.dense_features(vol if tsize != size else None)
    feats = feats / torch.clamp(torch.linalg.vector_norm(feats, dim=0, keepdim=True), min=1e-12)
    return feats, rec, tsize


def structured_quality_experiment(
    size: int,
    fos: int | None = None,
    train_iterations: int = 150,
    n_annotations: int = 256,
    seed: int = 0,
    model_features: tuple = (8, 16, 32),
    model_linear: tuple = (32,),
    pos_encoding: bool = True,
    learning_rate: float = 1e-3,
    samples_per_iteration: int = 8,
    temperature: float = 1.0,
    train_size: int | None = None,
    phantom: str = "easy",
    device=None,
) -> dict:
    """Fast-vs-full A/B on a TRAINED (non-random) feature distribution: the
    dense contrastive CNN oracle's unit-norm full-resolution features, with
    the extraction's two slice-axis treatments emulated exactly (full: per
    sweep axis the adaptive pool S → fos; fast: the fos slices nearest the
    output grid, then the same pool), the three axes summed as the 'all'
    sweep sums them. Returns the same table shape as
    ``fastmode_quality_experiment`` plus training metadata.
    """
    from vittf_tpu_torch.core.synthetic import PHANTOMS
    from vittf_tpu_torch.ops.resize import adaptive_avg_pool
    from vittf_tpu_torch.pipeline.features import _subsample_slice_indices

    device = resolve_device(device)
    if fos is None:
        fos = max(size // 4, 4)
    vol, labels = PHANTOMS[phantom](size, seed=seed, device=device)
    n_classes = int(labels.max())
    names = ["background"] + [f"c{i}" for i in range(1, n_classes + 1)]

    feats, rec, tsize = _train_cnn_oracle_features(
        vol, labels, names, size, seed, train_iterations, model_features,
        model_linear, pos_encoding, learning_rate, samples_per_iteration,
        temperature, train_size, phantom, device,
    )
    annotations, n_fg = _phantom_annotations(labels, n_annotations, seed)

    def emulate(mode: str) -> torch.Tensor:
        per_axis = []
        for ax in range(3):  # slice axis of each sweep
            f = feats
            S = f.shape[1 + ax]
            if mode == "fast" and S > fos:
                pick = torch.from_numpy(_subsample_slice_indices(S, fos)).to(device)
                f = torch.index_select(f, 1 + ax, pick)
            per_axis.append(adaptive_avg_pool(f, (fos,) * 3))
        return (per_axis[0] + per_axis[1]) + per_axis[2]

    out: dict = {
        "size": size,
        "fos": fos,
        "n_annotations": n_annotations,
        "seed": seed,
        "phantom": phantom,
        "feature_source": "dense-contrastive-trained",
        "train_iterations": train_iterations,
        "final_train_loss": float(rec["loss"]),
        "classes": names[1:],
        "oracle": {
            "model_features": list(model_features),
            "model_linear": list(model_linear),
            "pos_encoding": pos_encoding,
            "learning_rate": learning_rate,
            "samples_per_iteration": samples_per_iteration,
            "temperature": temperature,
            "train_size": tsize,
        },
        "grid_ceiling": grid_ceiling_miou(labels, fos, device=device),
    }
    for mode in ("full", "fast"):
        out[mode] = _predict_and_score(vol, emulate(mode), annotations, labels, names, n_fg)
    out["iou_delta"] = out["full"]["mIoU_fg"] - out["fast"]["mIoU_fg"]
    return out


def refinement_quality_experiment(
    size: int,
    fos: int | None = None,
    phantom: str = "easy",
    seed: int = 0,
    n_annotations: int = 256,
    train_iterations: int = 600,
    oracle_kw: dict | None = None,
    features: torch.Tensor | None = None,
    feature_source: str = "dense-contrastive-trained",
    island_threshold: int = 69,
    device=None,
) -> dict:
    """The refinement stack's quality uplift: IoU with and without the 3-D
    bilateral solver and the largest-island filter, four cells (``base``,
    ``bls``, ``island``, ``bls_island``) on identical features and
    annotations. ``features``: an optional (F, fos³) feature volume (e.g. a
    ViT extraction); by default the strong CNN oracle is trained and its
    full-resolution features pooled to the fos grid.
    """
    from vittf_tpu_torch.core.synthetic import PHANTOMS
    from vittf_tpu_torch.ops.connected import filter_similarity_largest_island
    from vittf_tpu_torch.ops.resize import adaptive_avg_pool

    device = resolve_device(device)
    if fos is None:
        fos = max(size // 4, 4)
    vol, labels = PHANTOMS[phantom](size, seed=seed, device=device)
    n_classes = int(labels.max())
    names = ["background"] + [f"c{i}" for i in range(1, n_classes + 1)]

    okw = dict(
        model_features=(16, 32, 64), model_linear=(64,), pos_encoding=True,
        learning_rate=1e-3, samples_per_iteration=8, temperature=0.07,
        train_size=min(64, size),
    )
    okw.update(oracle_kw or {})
    if features is None:
        feats_full, rec, tsize = _train_cnn_oracle_features(
            vol, labels, names, size, seed, train_iterations,
            okw["model_features"], okw["model_linear"], okw["pos_encoding"],
            okw["learning_rate"], okw["samples_per_iteration"],
            okw["temperature"], okw["train_size"], phantom, device,
        )
        # the structured A/B's 'full' emulation: 3 identical per-axis pools
        features = 3.0 * adaptive_avg_pool(feats_full, (fos,) * 3)
        train_loss = float(rec["loss"])
    else:
        features = torch.as_tensor(features).to(device)
        train_loss = float("nan")

    annotations, n_fg = _phantom_annotations(labels, n_annotations, seed)
    out: dict = {
        "size": size,
        "fos": fos,
        "phantom": phantom,
        "seed": seed,
        "n_annotations": n_annotations,
        "feature_source": feature_source,
        "final_train_loss": train_loss,
        "island_threshold": island_threshold,
        "grid_ceiling": grid_ceiling_miou(labels, fos, device=device),
    }
    for bls in (False, True):
        sims = compute_similarities(vol, features, annotations, bilateral_solver=bls)
        for island in (False, True):
            cell = ("bls" if bls else "") + ("_" if bls and island else "") \
                + ("island" if island else "") or "base"
            maps = (
                {k: filter_similarity_largest_island(v, island_threshold)
                 for k, v in sims.items()}
                if island
                else sims
            )
            pred = fuse_predictions(maps, [0.25] * len(maps))
            pred = upscale_prediction(pred, tuple(vol.shape))  # device-resident
            out[cell] = _score(labels, pred, names, n_fg)
    out["bls_uplift"] = out["bls"]["mIoU_fg"] - out["base"]["mIoU_fg"]
    out["island_uplift"] = out["island"]["mIoU_fg"] - out["base"]["mIoU_fg"]
    out["stack_uplift"] = out["bls_island"]["mIoU_fg"] - out["base"]["mIoU_fg"]
    return out


def fastmode_seed_budget_sweep(
    size: int,
    params: dict,
    model_cfg,
    base_cfg: ExtractConfig,
    budgets: tuple = (64, 256, 1024),
    seeds: tuple = (0, 1, 2),
    phantom: str = "easy",
    device=None,
) -> dict:
    """ViT-path fast-vs-full A/B across annotation budgets × seeds (a fresh
    phantom and fresh annotations per seed); per-cell results plus a delta
    summary (mean / min / max over all cells)."""
    cells = []
    for budget in budgets:
        for seed in seeds:
            r = fastmode_quality_experiment(
                size, params, model_cfg, base_cfg,
                n_annotations=budget, seed=seed, phantom=phantom, device=device,
            )
            cells.append(
                {
                    "budget": budget,
                    "seed": seed,
                    "full_mIoU": r["full"]["mIoU_fg"],
                    "fast_mIoU": r["fast"]["mIoU_fg"],
                    "iou_delta": r["iou_delta"],
                }
            )
    deltas = [c["iou_delta"] for c in cells]
    return {
        "size": size,
        "budgets": list(budgets),
        "seeds": list(seeds),
        "cells": cells,
        "delta_mean": float(np.mean(deltas)),
        "delta_min": float(np.min(deltas)),
        "delta_max": float(np.max(deltas)),
    }
