"""User-study evaluation CLI — the reference ``evaluate_similarities.py``.

    python -m vittf_tpu_torch.cli.evaluate --data DIR --label labels.npy \
        --labels lung liver kidney [--cpu]

Port of ``vittf_tpu/cli/evaluate.py``. It runs on the first CUDA device and
raises when none is visible, unless ``--cpu`` is given.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path
from pprint import pprint


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Evaluate exported GUI predictions against GT labels")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--label", type=Path, default="userstudy/labels-10.npy")
    p.add_argument("--labels", type=str, nargs="+",
                   default=["lung", "liver", "kidney"],
                   help="Label names found in predictions (in order)")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.cli.infer import select_device
    from vittf_tpu_torch.pipeline.evaluate import evaluate_user_study

    results = evaluate_user_study(args.data, args.label, args.labels,
                                  device=select_device(args.cpu))
    pprint(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
