"""The control and the planted faults of the DINOv2 extraction cells, at a
cell's own size.

    python3 portbench/control_dinov2.py --workload <name> --seeds <n> [<n> ...] [--faults]

For each seed, on the cell's weights and phantom, against the fp32
reference (``reference/dinov2.py``) on the seed's lattice, it prints one
JSON line with the numbers the cell compares for:

- ``sound``: the program's features, one ``extract_features`` call as the
  timed window makes it (the readings the limits are set from);
- ``control``: the reference computed in the nearest precision below the
  configuration's bf16, its products on float8 e4m3 operands;
- with ``--faults``, the program given a planted fault (``planted``): the
  SwiGLU halves swapped in every block's w12, the register tokens left out,
  one block's LayerScale dropped.

and whether the cell's limits call each correct. The benchmark's runs do not
run this.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench.harness import extract_dinov2 as loop  # noqa: E402
from portbench.harness import spec  # noqa: E402
from portbench.harness.extract import feature_errors, lattice  # noqa: E402
from portbench.harness.outcome import limit_checks  # noqa: E402


def planted(model: dict, vit, params: dict):
    """(name, ViTConfig, weights) of each planted fault of the program's
    inputs; the reference keeps the sound ones."""
    H, depth = model["hidden_dim"], model["depth"]
    swapped = dict(params)
    for i in range(depth):
        for part in ("weight", "bias"):
            w = params[f"blocks.{i}.mlp.w12.{part}"]
            swapped[f"blocks.{i}.mlp.w12.{part}"] = torch.cat([w[H:], w[:H]])
    yield "swiglu halves swapped", vit, swapped
    no_regs = {k: v for k, v in params.items() if k != "register_tokens"}
    yield "registers omitted", dataclasses.replace(vit, num_register_tokens=0), no_regs
    k = depth // 2
    dropped = dict(params)
    for ls in ("ls1", "ls2"):
        dropped[f"blocks.{k}.{ls}.gamma"] = torch.ones_like(params[f"blocks.{k}.{ls}.gamma"])
    yield f"block {k} LayerScale dropped", vit, dropped


def seed_line(cell, seed: int, dev, faults: bool) -> dict:
    """The sound, control and (with ``faults``) planted-fault numbers of
    one seed, each with the cell's verdict."""
    from vittf_tpu_torch.pipeline.features import extract_features

    model, ex, vit, ecfg, params, vol = loop.make_inputs(cell, seed, dev)
    slots, ref = loop.reference_lattice(cell, model, ex, params, vol, seed)

    def program(cfg, p):
        return feature_errors(lattice(extract_features(vol, p, cfg, ecfg, device=dev)["k"],
                                      slots), ref)

    runs = {"sound": program(vit, params)}
    runs["control"] = feature_errors(
        loop.reference_lattice(cell, model, ex, params, vol, seed, "fp8")[1], ref)
    if faults:
        for name, cfg, p in planted(model, vit, params):
            runs[name] = program(cfg, p)
    return {name: dict(values, correct=all(c.ok for c in limit_checks(values, cell.limits)))
            for name, values in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = seed_line(cell, seed, dev, args.faults)
        print(json.dumps({"workload": args.workload, "seed": seed, **line,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
