"""Batch orchestration — the reference ``sub/*.sh`` fan-out as a CLI.

    python -m vittf_tpu_torch.cli.batch infer-all --root DATA --feature-output-size 96
    python -m vittf_tpu_torch.cli.batch predict-all --root DATA --num-samples 1024 8096
    python -m vittf_tpu_torch.cli.batch svm-rf-sweep --root DATA --num-samples 8 64 512

Replaces the SLURM shell loops (sub/infer_allvols96.sh,
sub/infer_predict_similarities{1024,8096}.sh, sub/run_svm_rf_ctorg10b.sh):
each volume directory under ``--root`` is processed through the matching
stage CLI; existing artifacts short-circuit (the same idempotency contract
the reference relies on). Multi-host fan-out maps one root shard per host
(``--shard i/n``).

Port of ``vittf_tpu/cli/batch.py`` over the port's stage CLIs, which run on
the first CUDA device; ``--cpu`` is passed on to each of them.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path


def _volume_dirs(root: Path, shard: str | None) -> list[Path]:
    dirs = sorted(d for d in root.iterdir() if d.is_dir() and (d / "volume.npy").exists())
    if not dirs and (root / "volume.npy").exists():
        dirs = [root]
    if shard:
        i, n = (int(x) for x in shard.split("/"))
        dirs = dirs[i::n]
    return dirs


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Batch fan-out over volume directories")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("infer-all")
    a.add_argument("--root", type=Path, required=True)
    a.add_argument("--feature-output-size", type=int, default=96)
    a.add_argument("--weights", type=str, default=None)
    a.add_argument("--cpu", action="store_true", help="Run the stage CLIs on the CPU")
    a.add_argument("--shard", type=str, default=None, help="i/n host shard")

    b = sub.add_parser("predict-all")
    b.add_argument("--root", type=Path, required=True)
    b.add_argument("--num-samples", type=float, nargs="+", default=[1024])
    b.add_argument("--bilateral-solver", action="store_true")
    b.add_argument("--cpu", action="store_true", help="Run the stage CLIs on the CPU")
    b.add_argument("--shard", type=str, default=None)

    c = sub.add_parser("svm-rf-sweep")
    c.add_argument("--root", type=Path, required=True)
    c.add_argument("--num-samples", type=float, nargs="+",
                   default=[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8096])
    c.add_argument("--sampling-mode", type=str, default="both")
    c.add_argument("--cpu", action="store_true", help="Run the stage CLIs on the CPU")
    c.add_argument("--shard", type=str, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli import infer as cli_infer
    from vittf_tpu_torch.cli import predict_ntf as cli_ntf
    from vittf_tpu_torch.cli import predict_svm_rf as cli_svm

    rc = 0
    cpu = ["--cpu"] if args.cpu else []
    dirs = _volume_dirs(args.root, args.shard)
    print(f"Processing {len(dirs)} volume dirs under {args.root}")
    for d in dirs:
        try:
            if args.cmd == "infer-all":
                argv2 = [
                    "--data-path", str(d / "volume.npy"),
                    "--feature-output-size", str(args.feature_output_size),
                ]
                if args.weights:
                    argv2 += ["--weights", args.weights]
                try:
                    cli_infer.main(argv2 + cpu)
                except SystemExit as e:  # existing cache → skip
                    if e.code not in (0, 1):
                        raise
            elif args.cmd == "predict-all":
                for ns in args.num_samples:
                    argv2 = ["--data", str(d), "--num-samples", str(ns)]
                    if args.bilateral_solver:
                        argv2.append("--bilateral-solver")
                    cli_ntf.main(argv2 + cpu)
            elif args.cmd == "svm-rf-sweep":
                for ns in args.num_samples:
                    cli_svm.main(
                        ["--data", str(d), "--num-samples", str(ns),
                         "--sampling-mode", args.sampling_mode] + cpu
                    )
        except Exception as e:  # keep the fan-out going, report at the end
            print(f"FAILED {d}: {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
