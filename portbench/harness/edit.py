"""Edit traffic: one painting user in a closed loop, no think time.

Set-up makes the weights and the phantom on the card, and from them the
feature volume both sides take: the plain ViT (``reference/vit.py``) in
bf16, the precision the configurations extract in, so that the program's
edit path and the reference start from the same features. It samples
``annotations_per_class`` annotations of every class from the phantom's
labels and draws each class's strokes, opens an ``InteractiveSession`` on
the features, serves the full annotation set once and then
``warm_rounds`` rounds of edits, so that every class has been recomputed
alone and, with refinement, every core key met so far has been captured.

An edit takes the next class round robin and replaces its oldest
``stroke`` annotations with the class's next stroke (a straight run of
voxels inside its structure), so each class keeps its count. The edit is
timed from ``update_annotations`` until the fused labels are on the host.

Correctness, after the window, on a seeded sample of the edits and the
last: each class map the session served (fetched after the edit's time)
against the plain pipeline (``reference/ntf.py``) fed the same features,
annotations and the configuration's ``similarity`` and ``refinement``
settings, and the served labels against the reference's fusion of the
served maps (``compare``).

Traffic keys: ``volume``, ``annotations_per_class``, ``stroke``,
``strokes_per_class``, ``warm_rounds``, ``bilateral_solver``,
``bls_shape_bucket``, ``dirty_tracking``, ``check_share`` (the share of
edits kept for the check), ``check_max`` (how many of them are compared).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import flops, inputs, spec
from portbench.harness.device import log, memory_peak, reset_peak, synchronize
from portbench.harness.extract import settings
from portbench.harness.outcome import Outcome, limit_checks
from portbench.harness.trace import Window, span

KEEP_SLOTS = 1 << 20  # edits a window can hold: the seeded keep mask's length


class Painter:
    """The annotation state of one user and the edits that change it."""

    def __init__(self, anns: dict, strokes: dict, stroke: int):
        self.names = list(anns)
        self.state = dict(anns)
        self.strokes = strokes
        self.stroke = stroke
        self.k = 0

    def edit(self) -> None:
        """Apply the next edit. Arrays are replaced, never written, so a
        kept ``dict(self.state)`` stays as it was."""
        ci = self.k % len(self.names)
        name, j = self.names[ci], self.k // len(self.names)
        arr = self.state[name].copy()
        slot = j % (arr.shape[0] // self.stroke)
        strokes = self.strokes[name]
        arr[slot * self.stroke:(slot + 1) * self.stroke] = strokes[j % len(strokes)]
        self.state[name] = arr
        self.k += 1


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, int(np.ceil(q / 100.0 * len(s))) - 1)]


def share_differ(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of voxels at which two uint8 volumes differ."""
    return float((a != b).float().mean())


def program_settings(cell) -> None:
    """Raise unless the session runs the configuration's similarity and
    refinement: it takes none of them, and runs the program's defaults."""
    from vittf_tpu_torch.ops.similarity import DEFAULT_EXPONENT, DEFAULT_THRESHOLD
    from vittf_tpu_torch.pipeline.refine import BLS_GRID_PARAMS

    spec.require(cell.config, "similarity", (), {
        "dtype": "float32", "threshold": DEFAULT_THRESHOLD, "exponent": DEFAULT_EXPONENT})
    spec.require(cell.config, "refinement", (), {
        "dtype": "float32", "sigma_spatial": BLS_GRID_PARAMS["sigma_spatial"],
        "sigma_luma": BLS_GRID_PARAMS["sigma_luma"], "lam": 256.0, "cg_maxiter": 25})


def make_inputs(cell, seed: int, dev):
    """(volume, features, painter) of a run: the phantom, the feature volume
    the plain ViT makes from it in bf16, and the user with its annotations
    and strokes."""
    from portbench.reference import vit as reference_vit

    tr = cell.traffic
    model, ex = settings(cell)
    t0 = time.perf_counter()
    vol, labels = inputs.phantom(int(tr["volume"]), seed, dev)
    params = inputs.vit_weights(model, seed, dev)
    labels_np = labels.cpu().numpy()
    t1 = time.perf_counter()
    feats = reference_vit.extract(vol, params, model, ex, "bf16")
    del params
    synchronize(dev)
    log(f"phantom and weights {t1 - t0:.2f} s, features {time.perf_counter() - t1:.2f} s")
    A, L = int(tr["annotations_per_class"]), int(tr["stroke"])
    anns = inputs.annotations_from_labels(labels_np, A, inputs.host_rng(seed, "annotations"))
    strokes = {name: inputs.strokes(labels_np, int(name[3:]), int(tr["strokes_per_class"]), L,
                                    inputs.host_rng(seed, f"strokes {name}"))
               for name in anns}
    return vol, feats, Painter(anns, strokes, L)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Outcome:
    """One run of an edit cell; ``device='cpu'`` runs the program's plain
    twins, for the tests."""
    from vittf_tpu_torch import kernels
    from vittf_tpu_torch.ops.similarity import similarity as k2
    from vittf_tpu_torch.pipeline.session import InteractiveSession
    from vittf_tpu_torch.utils.cuda_graphs import GRAPHS

    tr = cell.traffic
    program_settings(cell)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        kernels.load_library()
    log(f"library loaded {time.perf_counter() - t_start:.2f} s in")
    vol, feats, painter = make_inputs(cell, seed, dev)
    A = int(tr["annotations_per_class"])
    feats_ref = feats.cpu()
    vol_np = vol.cpu().numpy()
    session = InteractiveSession(
        vol_np, feats, bilateral_solver=bool(tr["bilateral_solver"]),
        bls_shape_bucket=tr.get("bls_shape_bucket"), dirty_tracking=bool(tr["dirty_tracking"]),
        device=dev)
    del feats

    def serve() -> np.ndarray:
        with span("update_annotations"):
            session.update_annotations(painter.state)
        with span("predict"):
            pred = session.predict()
        with span("fetch"):
            return pred.cpu().numpy()

    log(f"inputs and session made {time.perf_counter() - t_start:.2f} s in")
    serve()
    for _ in range(int(tr["warm_rounds"]) * len(painter.names)):
        painter.edit()
        serve()
    synchronize(dev)
    setup_s = time.perf_counter() - t_start

    keep = inputs.host_rng(seed, "checked edits").random(KEEP_SLOTS) < float(tr["check_share"])
    graphs0, k2_0 = (GRAPHS.hits, GRAPHS.misses, GRAPHS.eager), k2.launches
    latencies, kept = [], {}
    reset_peak(dev)
    with Window(trace) as w:
        deadline = w.t0 + seconds
        while True:
            painter.edit()
            t0 = time.perf_counter()
            got = serve()
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            i = len(latencies) - 1
            if keep[i % KEEP_SLOTS] or t1 >= deadline:  # fetched after the edit's time
                maps = {n: session.similarities[n].cpu() for n in painter.names}
                kept[i] = (got, maps, dict(painter.state))
            if t1 >= deadline:
                break
        w.close()
    peak = memory_peak(dev)
    graphs = [a - b for a, b in zip((GRAPHS.hits, GRAPHS.misses, GRAPHS.eager), graphs0)]
    k2_launches = k2.launches - k2_0
    del session
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    values = compare(cell, seed, vol, feats_ref.to(dev), kept)
    log(f"{len(latencies)} edits in {w.seconds:.3f} s; graphs {graphs}; reference "
        f"{time.perf_counter() - t_ref:.1f} s; {values}")
    n_edits = len(latencies)
    dirty = 1 if tr["dirty_tracking"] else len(painter.names)
    V = int(np.prod(feats_ref.shape[1:]))
    per_edit = (flops.similarity_flops(V, feats_ref.shape[0], dirty * A, dirty),
                flops.similarity_bytes(V, feats_ref.shape[0], dirty * A, dirty))
    return Outcome(
        end_to_end={"setup_s": setup_s,
                    "edit_p50_ms": 1e3 * float(np.median(latencies)),
                    "edit_p95_ms": 1e3 * percentile(latencies, 95)},
        attempted=n_edits, failed=0, checks=limit_checks(values, cell.limits),
        memory_peak_bytes=peak, window_s=w.seconds, trace=w.trace,
        work={"similarity": [(n_edits, *per_edit)], "similarity_flops": n_edits * per_edit[0]},
        counters={"graph_hits": graphs[0], "graph_misses": graphs[1], "graph_eager": graphs[2],
                  "similarity_launches": k2_launches})


def compare(cell, seed: int, vol, feats, kept: dict) -> dict:
    """For a seeded sample of the kept edits ({edit: (labels, class maps,
    annotation state)}), the last one always among them:

    - maps_differ: the largest share, over the compared class maps, of a
      map's voxels that differ from the reference's map for the same
      annotations;
    - fuse_differ: the largest share of label voxels that differ from the
      reference's fusion of the program's own maps (exact: limit 0);
    - labels_differ, not held to a limit: the share of label voxels that
      differ from the reference's labels; it moves only at near ties, where
      one level decides, so no precision control separates it from a sound
      run (PERF.md)."""
    from portbench.reference import ntf

    tr = cell.traffic
    last = max(kept)
    rest = sorted(set(kept) - {last})
    rng = inputs.host_rng(seed, "compared edits")
    n = min(len(rest), int(tr["check_max"]))
    picked = sorted(rng.choice(rest, size=n, replace=False).tolist()) + [last] if n else [last]
    ref_u8 = ntf.half_reference(vol) if tr["bilateral_solver"] else None
    vol_shape = tuple(vol.shape)
    cache: dict = {}

    def ref_map(name, coords):
        key = (name, coords.tobytes())
        if key not in cache:
            cache[key] = ntf.class_map(feats, coords, vol_shape, cell.config, ref_u8,
                                       int(tr.get("bls_shape_bucket") or 8))
        return cache[key]

    out = {"fuse_differ": 0.0, "labels_differ": 0.0}
    map_shares = {}  # (class, annotations) → share: a map kept by several edits counts once
    for i in picked:
        labels, maps, state = kept[i]
        labels = torch.as_tensor(labels).to(feats.device)
        maps = {n: torch.as_tensor(m).to(feats.device) for n, m in maps.items()}
        refs = [ref_map(n, state[n]) for n in state]
        for n, r in zip(state, refs):
            map_shares[(n, state[n].tobytes())] = share_differ(maps[n], r)
        out["fuse_differ"] = max(out["fuse_differ"],
                                 share_differ(labels, ntf.fuse([maps[n] for n in state])))
        out["labels_differ"] = max(out["labels_differ"], share_differ(labels, ntf.fuse(refs)))
    out["maps_differ"] = max(map_shares.values())
    out["edits_compared"] = len(picked)
    return out
