"""Conversion CLI — the reference ``conversion/*`` scripts as subcommands.

    python -m vittf_tpu_torch.cli.convert resize --data v.npy --resolution 0.5 0.5 0.5
    python -m vittf_tpu_torch.cli.convert halfz --data v.npy
    python -m vittf_tpu_torch.cli.convert raw --data v.raw --shape 512 512 1873 4
    python -m vittf_tpu_torch.cli.convert tiff --data DIR
    python -m vittf_tpu_torch.cli.convert dcm --data DIR --output out.npy

Port of ``vittf_tpu/cli/convert.py``. ``resize``, ``halfz`` and ``quaterz``
resize on the first CUDA device and raise when none is visible, unless
``--cpu`` is given; the other subcommands are host-only file work.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path


def build_parser() -> ArgumentParser:
    p = ArgumentParser("Volume conversion tools")
    p.add_argument("--cpu", action="store_true", help="Resize on the CPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("resize")
    r.add_argument("--data", type=Path, required=True)
    r.add_argument("--resolution", type=float, nargs=3, required=True)
    r.add_argument("--output", type=Path, default=None)

    h = sub.add_parser("halfz")
    h.add_argument("--data", type=str, required=True)
    q = sub.add_parser("quaterz")
    q.add_argument("--data", type=str, required=True)

    w = sub.add_parser("raw")
    w.add_argument("--data", type=str, required=True)
    w.add_argument("--shape", type=int, nargs="+", required=True)
    w.add_argument("--dtype", type=str, default="uint8")
    w.add_argument("--output", type=str, default=None)

    t = sub.add_parser("tiff")
    t.add_argument("--data", type=Path, required=True,
                   help="Directory of per-volume subdirectories of .tif slices")

    d = sub.add_parser("dcm")
    d.add_argument("--data", type=Path, required=True)
    d.add_argument("--output", type=Path, required=True)
    d.add_argument("--nifti", action="store_true")

    n = sub.add_parser("nifti")
    n.add_argument("--data", type=Path, required=True)
    n.add_argument("--output", type=Path, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vittf_tpu_torch.convert import volumes as cv

    if args.cmd in ("resize", "halfz", "quaterz"):
        from vittf_tpu_torch.cli.infer import select_device

        device = select_device(args.cpu)
    if args.cmd == "resize":
        cv.resize_volume(args.data, tuple(args.resolution), args.output, device=device)
    elif args.cmd == "halfz":
        cv.downsample_z(args.data, 2, device=device)
    elif args.cmd == "quaterz":
        cv.downsample_z(args.data, 4, device=device)
    elif args.cmd == "raw":
        cv.raw_to_npy(args.data, tuple(args.shape), args.dtype, args.output)
    elif args.cmd == "tiff":
        for sub in Path(args.data).iterdir():
            if sub.is_dir():
                try:
                    cv.tiff_to_npy(sub, sub.parent / f"{sub.name}.npy")
                except FileNotFoundError as e:
                    print(e)
    elif args.cmd == "dcm":
        cv.dcm_to_npy(args.data, args.output, save_nifti=args.nifti)
    elif args.cmd == "nifti":
        cv.nifti_to_npy(args.data, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
