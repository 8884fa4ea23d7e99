"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; every file a cell
needs lies under ``portbench/`` and is found from the names in it:

- a configuration: the ``file`` its entry gives (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``loop`` key names the
  general loop that reads it (``harness/extract.py`` or ``harness/edit.py``);
- the limits of the cell's correctness check: ``limits/<workload>.json``;
- a per-layer metric: ``layer_metrics/<metric>.py``, a module with
  ``read(ctx) -> float | None``.

Nothing here knows a configuration, a mix or a metric by name, so a later
change adds one as new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it reads."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_file: Path | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench_file`` (the checkout's
    ``BENCHMARK.json``), its traffic and limits under ``bench_dir``; raises
    KeyError when it names no such cell or configuration."""
    bench_file = bench_file or ROOT / "BENCHMARK.json"
    bench = _read_json(bench_file)
    root = bench_file.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"BENCHMARK.json names no workload {workload!r}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def require(config: dict, section: str, known: tuple, fixed: dict) -> dict:
    """The ``section`` of a configuration, after checking that it names only
    ``known`` keys and holds the value ``fixed`` gives for each of its keys:
    the harness, its reference or the program runs nothing else. Raises
    ValueError on any other key or value, so a configuration is never run
    and checked as another."""
    part = config[section]
    unknown = sorted(set(part) - set(known) - set(fixed))
    if unknown:
        raise ValueError(f"{section}: the harness reads no key {unknown}")
    for key, value in fixed.items():
        if part.get(key) != value:
            raise ValueError(f"{section}.{key} is {part.get(key)!r}; only {value!r} is run")
    return part


def layer_reader(metric: str):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    path = BENCH_DIR / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric}", path)
    if spec is None:
        raise KeyError(f"no reader for per-layer metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
