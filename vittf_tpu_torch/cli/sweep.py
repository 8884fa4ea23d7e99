"""Grid-sweep runner (reference old/sweep_*.yml capability, wandb-free).

    python -m vittf_tpu_torch.cli.sweep --config configs/sweep_contrastive.yaml \
        --data data.pt

Expands the YAML grid, runs each configuration through the training CLI's
trainer factory, and reports the best configuration by the sweep metric.
Logs per-run JSONL into ``--out``.
"""
from __future__ import annotations

import itertools
import json
import sys
from argparse import ArgumentParser, Namespace
from pathlib import Path

import yaml


def expand_grid(grid: dict) -> list[dict]:
    keys = sorted(grid)
    return [
        dict(zip(keys, vals))
        for vals in itertools.product(*(grid[k] for k in keys))
    ]


def main(argv=None) -> int:
    p = ArgumentParser("Run a hyperparameter grid sweep")
    p.add_argument("--config", type=Path, required=True)
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--out", type=Path, default=Path("sweep_results"))
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    args = p.parse_args(argv)

    from vittf_tpu_torch.cli.train import _make_trainer, load_train_data

    with open(args.config) as f:
        sweep = yaml.safe_load(f)
    grid = expand_grid(sweep["grid"])
    fixed = sweep.get("fixed", {})
    metric = sweep["metric"]
    sign = -1.0 if sweep.get("goal", "minimize") == "minimize" else 1.0

    vol, mask, labels = load_train_data(args.data)
    args.out.mkdir(parents=True, exist_ok=True)
    results = []
    for i, point in enumerate(grid):
        cfg = {**fixed, **point}
        targs = Namespace(
            trainer=sweep["trainer"],
            iterations=int(cfg.get("iterations", 300)),
            learning_rate=float(cfg.get("learning_rate", 1e-3)),
            batch_size=int(cfg.get("batch_size", 32)),
            lr_schedule=cfg.get("lr_schedule", "onecycle"),
            label_percentage=float(cfg.get("label_percentage", 1.0)),
            lambda_std=float(cfg.get("lambda_std", 0.0)),
            seed=args.seed,
            cpu=args.cpu,
        )
        trainer = _make_trainer(targs, vol, mask, labels)
        last = {}
        for _ in range(targs.iterations):
            rec = trainer.step()
            last = rec if isinstance(rec, dict) else {"loss": rec}
        score = float(last.get(metric, last.get("loss", float("nan"))))
        results.append({"point": cfg, "final": last, "score": score})
        print(f"[{i + 1}/{len(grid)}] {point} -> {metric}={score:.5f}")

    best = max(results, key=lambda r: sign * r["score"])
    summary = {"metric": metric, "best": best, "runs": results}
    with open(args.out / "sweep.json", "w") as f:
        json.dump(summary, f, indent=2)
    print("Best:", best["point"], f"{metric}={best['score']:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
