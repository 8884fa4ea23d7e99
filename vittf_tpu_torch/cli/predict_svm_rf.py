"""SVM/RF baseline CLI — the reference ``predict_svm_rf.py`` surface.

    python -m vittf_tpu_torch.cli.predict_svm_rf --data DIR --num-samples 8096

Port of ``vittf_tpu/cli/predict_svm_rf.py`` with the same flags. Reproduces
the flow at predict_svm_rf.py:95-289: z-flips, annotation sampling (with
the background class at max-class-count, from labels==0 or the border
shell), feature choice (11-dim composed / intensity / DINO), dense predict,
per-classifier metrics JSON + prediction artifacts. Feature composition and
``--device-predict`` run on the first CUDA device and raise when none is
visible, unless ``--cpu`` is given.
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Predict segmentation using SVM and Random Forests")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--svm-kernel", type=str, default="rbf",
                   choices=["linear", "poly", "rbf", "sigmoid", "precomputed"])
    p.add_argument("--use-intensity-only", action="store_true")
    p.add_argument("--use-dino-features", action="store_true")
    p.add_argument("--num-samples", type=float, default=0.0)
    p.add_argument("--sampling-mode", type=str,
                   choices=["uniform", "surface", "both"], default="uniform")
    p.add_argument("--exclude-bg", action="store_true")
    p.add_argument("--no-svm", action="store_true")
    p.add_argument("--no-rf", action="store_true")
    p.add_argument("--rf-estimators", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device-predict", action="store_true",
        help="evaluate the dense SVM prediction on the device (OvO decision"
             " function; rbf/linear kernels) instead of sklearn on CPU",
    )
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli.infer import select_device
    from vittf_tpu_torch.core.io import ArtifactDir, load_features
    from vittf_tpu_torch.ops.resize import resize_nearest
    from vittf_tpu_torch.pipeline.annotations import (
        SAMPLING_MODES,
        annotations_from_labels,
    )
    from vittf_tpu_torch.pipeline.baselines import (
        compose_features,
        run_svm_rf,
        sample_background_border,
    )

    device = select_device(args.cpu)
    d = Path(args.data)
    ad = ArtifactDir(d)
    feat_str = (
        "_intensity" if args.use_intensity_only
        else "_dino" if args.use_dino_features
        else ""
    )
    bg_str = "_nobg" if args.exclude_bg else ""
    suffix = f"{args.num_samples}{args.sampling_mode}{feat_str}{bg_str}"
    if (d / f"svm_metrics{suffix}.json").exists() and (
        d / f"rf_metrics{suffix}.json"
    ).exists():
        print(f"Already inferred SVM and RF metrics for {d} ({suffix})")
        return 0

    volume = np.flip(ad.volume(), axis=-3).copy()
    labels = ad.labels()
    if labels is not None:
        labels = np.asarray(np.flip(labels, axis=-3)).copy()

    rng = np.random.default_rng(args.seed)
    if args.num_samples == 0.0:
        annotations = ad.annotations()
    else:
        if labels is None:
            raise ValueError("Cannot sample annotations without labels.npy")
        annotations = annotations_from_labels(
            labels, args.num_samples, args.sampling_mode, rng=rng, device=device
        )
    if not args.exclude_bg:
        bg_n = max(v.shape[0] for v in annotations.values())
        draw = SAMPLING_MODES[args.sampling_mode]
        if labels is not None:
            annotations["background"] = draw(
                torch.from_numpy(labels == 0).to(device), bg_n, rng=rng
            )
        else:
            annotations["background"] = draw(
                torch.from_numpy(sample_background_border(volume.shape)).to(device),
                bg_n, rng=rng,
            )

    if args.use_intensity_only:
        features = torch.from_numpy(volume)[None]
    elif args.use_dino_features:
        features = torch.from_numpy(load_features(ad.features_path()))
        labels = resize_nearest(
            torch.from_numpy(labels), tuple(features.shape[-3:])
        ).numpy()
    else:
        features = compose_features(torch.from_numpy(volume).to(device))

    results = run_svm_rf(
        volume, annotations, labels=labels, features=features,
        svm_kernel=args.svm_kernel,
        run_svm=not args.no_svm, run_rf=not args.no_rf,
        rf_estimators=args.rf_estimators, exclude_bg=args.exclude_bg,
        device_predict=args.device_predict, device=device,
    )
    for name, res in results.items():
        np.save(d / f"{name}_pred{suffix}.npy", res["pred"])
        _save_pred_histogram(res["pred"], name, d / f"{name}_pred{suffix}.png")
        if "metrics" in res:
            with open(d / f"{name}_metrics{suffix}.json", "w") as f:
                json.dump(res["metrics"], f)
            print(f"{name}: mIoU={res['metrics']['mIoU']:.4f} "
                  f"fit={res['fit_time']:.1f}s predict={res['predict_time']:.1f}s")
    return 0


def _save_pred_histogram(pred: np.ndarray, title: str, out_path) -> None:
    """Prediction label histogram figure (predict_svm_rf.py:181-219 saves
    the same per-classifier histograms)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(dpi=150, tight_layout=True)
    flat = pred.reshape(-1)
    ax.hist(flat, bins=np.arange(flat.max() + 2) - 0.5)
    ax.set_title(title)
    ax.set_xlabel("predicted label")
    fig.savefig(out_path)
    plt.close(fig)


if __name__ == "__main__":
    sys.exit(main())
