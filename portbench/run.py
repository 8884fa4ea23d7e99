"""Run one cell of the benchmark of vittf_tpu_torch and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. The cell, its
configuration, traffic mix, limits and per-layer readers are found by name
from ``BENCHMARK.json`` (``harness/spec.py``); the traffic file's
``loop`` names the general loop that runs it (``harness/<loop>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number of the correctness comparison with its limit, which also end
standard error. No result is printed, and the exit code is not 0, when
no card is visible, when the cell asks for more cards than there are,
or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vittf_tpu")  # top-level module names, compared whole


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds; the program's own library cache is
    ``vittf_tpu_torch/_build``, also inside it."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    loop = importlib.import_module(f"portbench.harness.{cell.traffic['loop']}")
    out = loop.run(cell, args.seed, args.seconds, bool(args.trace), T_START)

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4

    metrics = {}
    t_read = time.perf_counter()
    if args.trace:
        for m in cell.per_layer:
            value = spec.layer_reader(m["name"])(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
        print(f"portbench: per-layer metrics and breakdown read "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    print(json.dumps(result), flush=True)
    for c in out.checks:
        print(f"check {c.name} {c.value} limit {c.limit} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
