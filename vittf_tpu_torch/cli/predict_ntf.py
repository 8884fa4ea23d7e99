"""NTF predictor CLI — the reference ``predict_ntf.py`` command surface.

    python -m vittf_tpu_torch.cli.predict_ntf --data DIR [--bilateral-solver]
        [--largest-island] [--num-samples N] [--sampling-mode both] [--cpu]

Port of ``vittf_tpu/cli/predict_ntf.py`` with the same flags and artifacts:
volume + labels z-flips, largest-features selection, synthetic annotation
sampling from GT, per-class similarity (split per class when ΣA > 10000),
optional bilateral refinement with per-class tight crops
(``--bilateral-solver``) and largest-island filter (``--largest-island``),
per-class threshold + max-sim fusion, ``ntf_pred{...}.npy`` +
``ntf_metrics{...}.json`` (the suffix gains ``bls`` and ``isl`` with those
flags). It runs on the first CUDA device (``--cpu`` for the CPU).
"""
from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Predict segmentation from NTF similarity maps")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--bilateral-solver", action="store_true")
    p.add_argument("--load-sims", action="store_true")
    p.add_argument("--num-samples", type=float, default=0.0)
    p.add_argument("--sampling-mode", type=str,
                   choices=["uniform", "surface", "both"], default="both")
    p.add_argument("--impl", type=str, default="auto", choices=["auto", "plain"],
                   help="'auto': the CUDA kernels on the GPU; 'plain': their plain twins")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--largest-island", action="store_true",
                   help="keep only each class's largest connected similarity island "
                        "before fusion (reference cc_torch post-filter)")
    p.add_argument("--island-threshold", type=int, default=69,
                   help="uint8 threshold defining islands (default 69)")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli.infer import select_device
    from vittf_tpu_torch.core.io import ArtifactDir, load_features
    from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
    from vittf_tpu_torch.pipeline.evaluate import segmentation_metrics
    from vittf_tpu_torch.pipeline.ntf import (
        CT_ORG_THRESHOLDS,
        compute_similarities,
        fuse_predictions,
        upscale_prediction,
    )

    device = select_device(args.cpu)
    d = Path(args.data)
    ad = ArtifactDir(d)
    if args.num_samples == 0.0:
        args.sampling_mode = "annotated"
    bls_str = "bls" if args.bilateral_solver else ""
    isl_str = "isl" if args.largest_island else ""
    suffix = f"{args.num_samples}{args.sampling_mode}{bls_str}{isl_str}"
    out_pred = d / f"ntf_pred{suffix}.npy"
    if out_pred.exists():
        print(f"Already inferred NTF preds for {d} ({suffix})")
        return 0

    volume = np.flip(ad.volume(), axis=-3).copy()
    labels = ad.labels()
    if labels is not None:
        labels = np.flip(labels, axis=-3).copy()
    features = load_features(ad.features_path())

    if args.num_samples == 0.0:
        annotations = ad.annotations()
    else:
        if labels is None:
            raise ValueError("Cannot sample annotations without labels.npy")
        annotations = annotations_from_labels(
            labels, args.num_samples, args.sampling_mode,
            rng=np.random.default_rng(args.seed), device=device,
        )

    t0 = time.time()
    feat_t = torch.from_numpy(features).to(device)
    t1 = time.time()
    if args.load_sims:
        similarities = {
            k: torch.from_numpy(v).to(device) for k, v in ad.similarities().items()
        }
        t2 = t1
    else:
        total = sum(int(v.shape[0]) for v in annotations.values())
        t1 = time.time()
        if total > 10000:
            # per-class computation (predict_ntf.py:185-188)
            similarities = {
                k: compute_similarities(volume, feat_t, {k: v},
                                        bilateral_solver=args.bilateral_solver,
                                        impl=args.impl)[k]
                for k, v in annotations.items()
            }
        else:
            similarities = compute_similarities(
                volume, feat_t, annotations, bilateral_solver=args.bilateral_solver,
                impl=args.impl,
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.time()

    if args.largest_island:
        from vittf_tpu_torch.ops.connected import filter_similarity_largest_island

        similarities = {
            k: filter_similarity_largest_island(v, args.island_threshold)
            for k, v in similarities.items()
        }
    pred = fuse_predictions(similarities, CT_ORG_THRESHOLDS)
    np.save(out_pred, pred.cpu().numpy().astype(np.uint8))
    pred_full = upscale_prediction(pred, volume.shape)
    print("Pred:", tuple(pred_full.shape), int(pred_full.min()), int(pred_full.max()))
    print("NTF fit time:", t1 - t0)
    print("NTF predict time:", t2 - t1)

    if labels is None:
        return 0
    label_names = ["background"] + list(annotations.keys())
    metrics = segmentation_metrics(
        torch.from_numpy(labels).to(device), pred_full, label_names,
        extra={"fit_time": t1 - t0, "predict_time": t2 - t1},
    )
    print(json.dumps(metrics, indent=2))
    with open(d / f"ntf_metrics{suffix}.json", "w") as f:
        json.dump(metrics, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
