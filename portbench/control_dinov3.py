"""The control and the planted faults of the DINOv3 extraction cell, at the
cell's own size.

    python3 portbench/control_dinov3.py --workload <name> --seeds <n> [<n> ...] [--faults]

For each seed, on the cell's weights and phantom, against the fp32
reference (``reference/dinov3.py``) on the seed's lattice, it prints one
JSON line with the numbers the cell compares for:

- ``sound``: the program's features, one ``extract_features`` call as the
  timed window makes it (the readings the limits are set from);
- ``control``: the reference computed in the nearest precision below the
  configuration's bf16, its products on float8 e4m3 operands;
- with ``--faults``, the program given a planted fault (``planted``): RoPE
  dropped (a table of cos 1, sin 0), RoPE on the prefix rows too (K1 built
  with the rotation's prefix test removed: CLS and the storage tokens turn
  at patch 0's angles), interleaved pairs for halves (q's and k's head dims
  reordered in every attention block, so the kernel's halves are the
  published code's neighbouring pairs), the storage tokens left out.

and whether the cell's limits call each correct. The benchmark's runs do not
run this.
"""
import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench.harness import extract_dinov3 as loop  # noqa: E402
from portbench.harness import spec  # noqa: E402
from portbench.harness.extract import feature_errors, lattice  # noqa: E402
from portbench.harness.outcome import limit_checks  # noqa: E402

# K1's rotation without its prefix test (csrc/attention_core.cuh::rope_rotate)
PREFIX_EDIT = [("attention_core.cuh",
                "  const int p = abs_row - rope.prefix;\n  if (p < 0 || abs_row >= n_valid) return;",
                "  const int p = max(abs_row - rope.prefix, 0);\n  if (abs_row >= n_valid) return;")]


def interleaved(params: dict, model: dict) -> dict:
    """Every attention block's q and k rows reordered per head so that the
    halves the program rotates together, dims i and hd/2 + i, are dims 2i and
    2i + 1 of the published head: the scores are those of RoPE on
    neighbouring pairs. The last block, whose k is captured before RoPE, is
    left as it is."""
    D, heads = model["embed_dim"], model["num_heads"]
    hd = D // heads
    order = torch.cat([torch.arange(0, hd, 2), torch.arange(1, hd, 2)])
    rows = torch.cat([h * hd + order for h in range(2 * heads)])  # q's heads, then k's
    out = dict(params)
    for i in range(model["depth"] - 1):
        name = f"blocks.{i}.attn.qkv.weight"
        w = params[name]
        out[name] = torch.cat([w[rows.to(w.device)], w[2 * D:]])
    return out


@contextlib.contextmanager
def no_rotation():
    """The program's RoPE table patched to cos 1, sin 0."""
    from vittf_tpu_torch.models import vit

    real = vit.rope_table

    def identity(grid_hw, head_dim, base, device=None):
        table = real(grid_hw, head_dim, base, device)
        return torch.stack([torch.ones_like(table[0]), torch.zeros_like(table[1])])

    vit.rope_table = identity
    try:
        yield
    finally:
        vit.rope_table = real


@contextlib.contextmanager
def prefix_rotated():
    from vittf_tpu_torch import kernels
    from vittf_tpu_torch.scripts.kernel_variants import edited_library

    with edited_library(PREFIX_EDIT, kernels):
        yield


def planted(model: dict, vit, params: dict):
    """(name, context, ViTConfig, weights) of each planted fault; the
    reference keeps the sound ones."""
    yield "RoPE dropped", no_rotation(), vit, params
    yield "RoPE on the prefix rows", prefix_rotated(), vit, params
    yield "interleaved pairs for halves", contextlib.nullcontext(), vit, interleaved(params, model)
    no_storage = {k: v for k, v in params.items() if k != "register_tokens"}
    yield ("storage tokens omitted", contextlib.nullcontext(),
           dataclasses.replace(vit, num_register_tokens=0), no_storage)


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
        for name, context, cfg, p in planted(model, vit, params):
            with context:
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
