"""Training CLI: the legacy trainer capability surface as one command.

    python -m vittf_tpu_torch.cli.train --trainer semisparse --data data.pt \
        --iterations 500 --ckpt-dir ckpts/ [--resume] [--cpu]

Port of ``vittf_tpu/cli/train.py`` with the same flags, plus ``--cpu``:
without it the trainer runs on the first CUDA device and the command raises
when none is visible. ``--data`` is the reference trainer data contract: a
``.pt``/``.npy`` dict with ``vol`` (W,H,D), ``mask`` (W,H,D int labels) and
``labels`` (list of class names) (old/train*.py:47-57). Trainers: semisparse
(InfoNCE over gathered crops), dense (full-volume InfoNCE), paws
(semi-supervised), intra_clr (self-supervised). Checkpoints are this
package's ``<dir>/step_<n>.pt`` files; ``--resume`` restores the parameters
and the step, not the optimizer state, as the JAX CLI does.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def load_train_data(path: str | Path):
    path = Path(path)
    if path.suffix in (".pt", ".pth"):
        data = torch.load(path, map_location="cpu", weights_only=False)
        vol = np.asarray(data["vol"].float())
        mask = np.asarray(data["mask"]).astype(np.int32)
        labels = list(data["labels"])
    else:
        data = np.load(path, allow_pickle=True)[()]
        if not isinstance(data, dict):
            raise SystemExit(
                f"--data {path} holds a bare array; the trainer contract "
                "(reference old/train.py) is a dict with 'vol' (W,H,D), "
                "'mask' (W,H,D int labels) and 'labels' (names). Build one "
                "with np.save(path, {'vol': v, 'mask': m, 'labels': names})."
            )
        vol = np.asarray(data["vol"], np.float32)
        mask = np.asarray(data["mask"]).astype(np.int32)
        labels = list(data["labels"])
    return vol, mask, labels


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Train a feature extractor on a labeled volume")
    p.add_argument("--trainer", type=str, required=True,
                   choices=["semisparse", "dense", "paws", "intra_clr"])
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr-schedule", type=str, default="onecycle",
                   choices=["onecycle", "cosine", "const"])
    p.add_argument("--label-percentage", type=float, default=1.0)
    p.add_argument("--lambda-std", type=float, default=0.0)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-jsonl", type=str, default=None)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def _make_trainer(args, vol, mask, labels):
    device = "cpu" if args.cpu else None
    if args.trainer == "semisparse":
        from vittf_tpu_torch.train.contrastive import ContrastiveConfig, ContrastiveTrainer

        cfg = ContrastiveConfig(
            batch_size=args.batch_size, learning_rate=args.learning_rate,
            schedule=args.lr_schedule, iterations=args.iterations,
            lambda_std=args.lambda_std,
        )
        return ContrastiveTrainer(vol, mask, cfg, seed=args.seed, device=device)
    if args.trainer == "dense":
        from vittf_tpu_torch.train.dense import DenseContrastiveConfig, DenseContrastiveTrainer

        cfg = DenseContrastiveConfig(
            learning_rate=args.learning_rate, schedule=args.lr_schedule,
            iterations=args.iterations, lambda_std=args.lambda_std,
            label_percentage=args.label_percentage,
        )
        return DenseContrastiveTrainer(vol, mask, labels, cfg, seed=args.seed, device=device)
    if args.trainer == "paws":
        from vittf_tpu_torch.train.paws import PAWSConfig, PAWSTrainer

        cfg = PAWSConfig(
            batch_size=args.batch_size, learning_rate=args.learning_rate,
            schedule=args.lr_schedule, iterations=args.iterations,
        )
        return PAWSTrainer(vol, mask, labels, cfg, seed=args.seed, device=device)
    from vittf_tpu_torch.train.intra_clr import IntraCLRConfig, IntraCLRTrainer

    cfg = IntraCLRConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        schedule=args.lr_schedule, iterations=args.iterations,
    )
    return IntraCLRTrainer(vol, cfg, seed=args.seed, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.models.serialization import restore_checkpoint, save_checkpoint
    from vittf_tpu_torch.train.optim import tree_leaves
    from vittf_tpu_torch.utils.logging import MetricLogger

    vol, mask, labels = load_train_data(args.data)
    trainer = _make_trainer(args, vol, mask, labels)
    logger = MetricLogger(jsonl_path=args.log_jsonl, stdout_every=args.log_every)

    start = 0
    if args.resume and args.ckpt_dir and Path(args.ckpt_dir).exists():
        state = restore_checkpoint(args.ckpt_dir, map_location=trainer.device)
        with torch.no_grad():  # in place: the optimizer keeps its leaves
            for p, saved in zip(tree_leaves(trainer.params), tree_leaves(state["params"])):
                p.copy_(saved)
        start = int(state["step"])
        print(f"Resumed from step {start}")

    for i in range(start, args.iterations):
        rec = trainer.step()
        logger.log(rec if isinstance(rec, dict) else {"loss": rec}, step=i + 1)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, {"params": trainer.params, "step": i + 1}, step=i + 1)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, {"params": trainer.params, "step": args.iterations},
                        step=args.iterations)
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
