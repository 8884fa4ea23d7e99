"""Reporting: metric aggregation and publication plots (reference C18:
plot_performance.py, summarize_userstudy.py, old/accumulate_metrics.py).

``accumulate_metrics`` means per-class/scalar metrics across metric-JSON
files (confusion matrices excluded, reference accumulate_metrics.py:36-61).
``plot_iou_vs_annotations`` recreates the broken-axis IoU plot with the
paper's published comparison points (Ours 0.981, SAM-Med3D turbo 0.957 /
organ 0.906, plot_performance.py:64-69). ``summarize_userstudy``
aggregates GUI-session metrics and the SUS questionnaire.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

PUBLISHED_POINTS = {  # plot_performance.py:64-69
    "Ours": (0.981, "purple", "*"),
    "SAM-Med3D (turbo)": (0.957, "green", "x"),
    "SAM-Med3D (organ)": (0.906, "orange", "x"),
}

SUS_QUESTIONS = [
    "I think that I would like to use this system frequently",
    "I found the system unnecessarily complex",
    "I thought the system was easy to use",
    "I think that I would need the support of a technical person to be able to use this system",
    "I found the various functions in this system were well integrated",
    "I thought there was too much inconsistency in this system",
    "I would imagine that most people would learn to use this system very quickly",
    "I found the system very cumbersome to use",
    "I felt very confident using the system",
    "I needed to learn a lot of things before I could get going with this system",
]


def accumulate_metrics(
    files: list[str | Path], exclude: tuple[str, ...] = ("confusion_matrix",)
) -> dict:
    """Mean metric JSONs across volumes/runs (accumulate_metrics.py flow)."""
    loaded = []
    for f in files:
        with open(f) as fp:
            loaded.append(json.load(fp))
    if not loaded:
        raise ValueError("No metric files given")
    names = [k for k in loaded[0] if k not in exclude]
    out: dict = {}
    for m in names:
        if isinstance(loaded[0][m], dict):
            per_class = defaultdict(list)
            for rec in loaded:
                for c, v in rec[m].items():
                    per_class[c].append(v)
            out[m] = {c: float(np.mean(v)) for c, v in per_class.items()}
        else:
            out[m] = float(np.mean([rec[m] for rec in loaded]))
    out["files"] = [str(f) for f in files]
    return out


def extract_num(path: str) -> float:
    """Annotation count from a metrics filename (e.g. 'rf_metrics512both')."""
    m = re.search(r"(\d+(?:\.\d+)?)", Path(path).stem.replace("metrics", ""))
    return float(m.group(1)) if m else 0.0


def plot_iou_vs_annotations(
    series: dict[str, dict[float, float]],
    out_path: str | Path,
    metric_label: str = "Intersection over Union",
    published: dict | None = None,
):
    """Broken-axis IoU-vs-#annotations comparison plot
    (plot_performance.py:35-83 styling: low band 0–0.55, high band
    0.88–1.0, published points as horizontal dotted lines).

    Args:
        series: {label: {num_annotations: mean_metric}} for the baselines.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    published = PUBLISHED_POINTS if published is None else published
    fig, (ax2, ax) = plt.subplots(
        2, 1, dpi=300, tight_layout=True, figsize=(6, 4), sharex=True
    )
    for a in (ax, ax2):
        a.set_facecolor("#ebebeb")
        a.spines["top"].set_visible(False)
        a.spines["right"].set_visible(False)
    ax.set_xlabel("Number of Annotations per Class")
    ax.set_ylim(0.0, 0.55)
    ax2.set_ylim(0.88, 1.0)
    ax2.tick_params(labelbottom=False, bottom=False)
    ax2.spines["bottom"].set_visible(False)
    fig.text(0.03, 0.55, metric_label, ha="center", va="center", rotation="vertical")

    for label, (val, color, marker) in published.items():
        ax2.scatter(0, val, label=label, color=color, marker=marker, s=64)
        ax2.axhline(y=val, xmin=0.05, color=color, linestyle="dotted", alpha=0.7)
    colors = ["blue", "red", "brown", "teal"]
    for i, (label, points) in enumerate(series.items()):
        xs = sorted(points)
        ys = [points[x] for x in xs]
        for a in (ax, ax2):
            a.plot(xs, ys, label=label, color=colors[i % len(colors)], marker="o")
    ax2.legend(loc="right", fontsize=8)
    out_path = Path(out_path)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def summarize_userstudy(
    metric_files: list[str | Path],
    out_dir: str | Path,
    metrics: tuple = ("accuracy", "precision", "recall", "iou", "f1",
                      "num_annotations", "annotation_time"),
    classes: tuple = ("lung", "liver", "kidney"),
    sus_results: list[float] | None = None,
    sus_stddevs: list[float] | None = None,
) -> dict:
    """Aggregate per-user GUI-session metrics.json files + SUS summary
    (summarize_userstudy.py flow). Writes a summary JSON and returns it.

    Deviation: for binary per-class metric lists [background, foreground]
    this takes the FOREGROUND entry; the reference's ``use_first`` takes
    element 0 (the background row) — almost certainly unintended, since
    the summary is about per-organ segmentation quality.
    """

    def first(a):
        return a[1] if isinstance(a, (list, tuple)) and len(a) > 1 else (
            a[0] if isinstance(a, (list, tuple)) else a
        )

    per_metric: dict = {m: defaultdict(list) for m in metrics}
    for f in metric_files:
        with open(f) as fp:
            rec = json.load(fp)
        for cls in classes:
            if cls not in rec:
                continue
            for m in metrics:
                if m in rec[cls]:
                    # binary per-class metrics: index 1 = foreground class
                    per_metric[m][cls].append(first(rec[cls][m]))

    summary = {
        m: {
            cls: {
                "mean": float(np.mean(v)) if v else None,
                "std": float(np.std(v)) if v else None,
                "n": len(v),
            }
            for cls, v in by_class.items()
        }
        for m, by_class in per_metric.items()
    }
    if sus_results is not None:
        summary["sus"] = [
            {"question": q, "mean": r, "std": s}
            for q, r, s in zip(SUS_QUESTIONS, sus_results, sus_stddevs or [None] * 10)
        ]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary
