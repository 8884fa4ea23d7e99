"""The controls of the benchmark's correctness checks, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--edits N]

Each control is the plain reference put in the program's place, computed in
the nearest precision below the one the configuration states, and held to
the cell's own comparison:

- extraction cells (bf16 compute): the ViT's products with float8 e4m3
  operands (``reference/vit.py`` precision 'fp8') against the fp32
  reference, on the seed's lattice of voxels;
- edit cells (fp32 similarity with TF32 off, fp32 refinement): the
  similarity's operands rounded to TF32 (a K2 on the tensor cores) and, with
  refinement, the solve's lattice to bf16 (``reference/ntf.py``
  ``control=True``) against the reference, over the first ``--edits`` edits
  of the seed's stroke sequence, sampled as a run samples its window.

Prints one JSON line a seed with the numbers the cell compares and whether
the cell's limits call them correct; the benchmark's runs do not run this.
It imports nothing of the program.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench.harness import extract, inputs, spec  # noqa: E402
from portbench.harness.edit import KEEP_SLOTS, compare, make_inputs  # noqa: E402
from portbench.harness.outcome import limit_checks  # noqa: E402
from portbench.reference import ntf  # noqa: E402
from portbench.reference import vit as reference_vit  # noqa: E402


def extract_control(cell, seed: int, dev) -> dict:
    model, ex = extract.settings(cell)
    params = inputs.vit_weights(model, seed, dev)
    vol, _ = inputs.phantom(int(cell.traffic["volume"]), seed, dev)
    _, grid = reference_vit.image_size(tuple(vol.shape), ex["feature_output_size"],
                                       model["patch_size"])
    slots = extract.check_slots(grid, int(cell.traffic["check_slots"]), seed)
    ref = reference_vit.extract(vol, params, model, ex, "fp32", slots)
    ctl = reference_vit.extract(vol, params, model, ex, "fp8", slots)
    return extract.feature_errors(ctl, ref)


def edit_control(cell, seed: int, dev, edits: int) -> dict:
    tr = cell.traffic
    vol, feats, painter = make_inputs(cell, seed, dev)
    ref_u8 = ntf.half_reference(vol) if tr["bilateral_solver"] else None
    bucket = int(tr.get("bls_shape_bucket") or 8)

    def control_map(name, coords):
        return ntf.class_map(feats, coords, tuple(vol.shape), cell.config, ref_u8, bucket,
                             control=True)

    for _ in range(int(tr["warm_rounds"]) * len(painter.names)):
        painter.edit()
    keep = inputs.host_rng(seed, "checked edits").random(KEEP_SLOTS) < float(tr["check_share"])
    kept, cache = {}, {}
    for i in range(edits):
        painter.edit()
        if keep[i] or i == edits - 1:
            st = dict(painter.state)
            for n, c in st.items():
                if (n, c.tobytes()) not in cache:
                    cache[(n, c.tobytes())] = control_map(n, c)
            maps = {n: cache[(n, c.tobytes())] for n, c in st.items()}
            kept[i] = (ntf.fuse(list(maps.values())), maps, st)
    return compare(cell, seed, vol, feats, kept)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--edits", type=int, default=2000)
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["loop"] == "extract":
            values = extract_control(cell, seed, dev)
        else:
            values = edit_control(cell, seed, dev, args.edits)
        checks = limit_checks(values, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": values,
                          "correct": all(c.ok for c in checks),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
