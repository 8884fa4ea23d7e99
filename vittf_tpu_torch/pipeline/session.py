"""Interactive session: resident features + per-edit similarity serving.

Port of ``vittf_tpu/pipeline/session.py``. The reference's interactive loop
lives in an external GUI module that talks through the artifact contract
(SURVEY.md §3.5): the GUI writes ``annotations.npy`` and reads back
``similarities.npy`` / ``predictions.npy``. ``InteractiveSession`` is the
serving side: features are extracted (or loaded) once and stay on the device,
and each annotation update recomputes only the classes that changed.
``watch_directory`` runs the loop against a directory, which makes any
frontend that speaks the artifact contract interactive.

The JAX twin pads the class axis to buckets (``class_bucket``) so that edits
reuse compiled graphs; nothing is compiled per shape here, so the class count
is always exact and ``prewarm`` is a single synthetic update.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from vittf_tpu_torch.core.io import load_features, save_array, save_similarities
from vittf_tpu_torch.pipeline.ntf import (
    CT_ORG_THRESHOLDS,
    compute_similarities,
    fuse_predictions,
    fuse_predictions_host,
)
from vittf_tpu_torch.utils.logging import span
from vittf_tpu_torch.utils.tensor import resolve_device as _resolve_device


def _default_thresholds(n: int) -> list[float]:
    return CT_ORG_THRESHOLDS[:n] if n <= len(CT_ORG_THRESHOLDS) else [0.25] * n


class InteractiveSession:
    """Volume + resident feature volume serving similarity queries."""

    def __init__(
        self,
        volume: np.ndarray,
        features,
        bilateral_solver: bool = False,
        impl: str = "auto",
        bls_shape_bucket: int | None = 8,
        largest_island: bool = False,
        island_threshold: int = 69,
        dirty_tracking: bool = True,
        device=None,
    ):
        self.device = _resolve_device(device)
        # the volume stays a host array: serving needs only its shape (the
        # annotations' relative coordinates) and, once, the half-res
        # refinement reference below
        self.volume = np.asarray(volume)
        if not torch.is_tensor(features):
            features = torch.from_numpy(np.asarray(features, np.float32))
        # held voxel-major: (F, W', H', D') in shape, (W', H', D', F) in
        # memory, so that every request's similarity kernel reads its (V, F)
        # rows in place and the sampler walks the channels contiguously. One
        # transposing copy here, none per edit.
        features = features.to(self.device, torch.float32)
        self.features = features.movedim(0, -1).contiguous().movedim(-1, 0)
        self.bilateral_solver = bilateral_solver
        self.impl = impl
        self.bls_shape_bucket = bls_shape_bucket
        # optional largest-island post-filter (reference cc_torch filter)
        self.largest_island = largest_island
        self.island_threshold = island_threshold
        # GUI edits touch one class per frame; with dirty tracking an update
        # recomputes (and refines) only the classes whose annotation arrays
        # changed, and the others serve their cached maps
        self.dirty_tracking = dirty_tracking
        self._last_annotations: dict[str, np.ndarray] = {}
        self.similarities: dict[str, torch.Tensor] = {}
        # updates served so far: the identifier an update's and the next
        # predict's profiler spans carry
        self.updates = 0
        # export host cache: name -> (the device tensor it was fetched from,
        # its host copy). Unchanged classes keep the same tensor object across
        # dirty updates, so their cached host bytes are exact and an export
        # copies only the changed maps to the host.
        self._export_cache: dict[str, tuple] = {}
        # the half-res refinement reference does not change between edits
        self._bls_ref_u8 = None
        if bilateral_solver:
            from vittf_tpu_torch.pipeline.refine import make_bls_reference

            self._bls_ref_u8 = make_bls_reference(self.volume, self.sim_shape,
                                                  device=self.device)

    @property
    def sim_shape(self) -> tuple[int, int, int]:
        return tuple(d // 2 for d in self.volume.shape[-3:])

    @classmethod
    def from_artifacts(cls, data_dir: str | Path, **kwargs) -> "InteractiveSession":
        from vittf_tpu_torch.core.io import ArtifactDir

        ad = ArtifactDir(data_dir)
        return cls(ad.volume(), load_features(ad.features_path()), **kwargs)

    @classmethod
    def extract(cls, volume: np.ndarray, params, model_cfg, extract_cfg=None,
                device=None, **kwargs) -> "InteractiveSession":
        from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

        device = _resolve_device(device)
        feats = extract_features(
            np.asarray(volume, np.float32), params, model_cfg,
            extract_cfg or ExtractConfig(), device=device,
        )["k"]
        return cls(volume, feats, device=device, **kwargs)

    def _compute(self, annotations, mean_first=None):
        return compute_similarities(
            self.volume, self.features, annotations,
            bilateral_solver=self.bilateral_solver, impl=self.impl,
            bls_shape_bucket=self.bls_shape_bucket, bls_ref_u8=self._bls_ref_u8,
            mean_first=mean_first,
        )

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prewarm(self) -> float:
        """Run one synthetic annotation update through the configured path
        (with the batched refinement when it is on) before the first real
        edit: on the card it builds and loads the kernel library and warms
        the allocator, so the first user edit runs at steady-state latency.
        Nothing here is compiled per class count, so the update's size (four
        classes of 64 annotations) is fixed. ``self.similarities`` is not
        touched. Returns the seconds it took."""
        rng = np.random.default_rng(0)
        shape = np.asarray(self.volume.shape[-3:])
        ann = {
            f"_warm{i}": rng.integers(0, shape, (64, 3)).astype(np.int64)
            for i in range(4)
        }
        t0 = time.perf_counter()
        self._compute(ann)
        self._synchronize()
        return time.perf_counter() - t0

    def update_annotations(self, annotations: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Recompute per-class similarity maps for new annotations.

        With ``dirty_tracking`` (default) only classes whose annotation
        arrays changed since the last update are recomputed; untouched
        classes keep their cached maps. Exact without refinement (per-class
        similarity and quantization are independent, and the mean-first
        decision is pinned to the full class set). With the bucketed
        refinement the common crop extent comes from the dirty subset only,
        which stays within that path's documented not-bit-parity envelope
        (``refine_similarities_batched``).
        """
        self.updates += 1
        with span("session.update", self.updates):
            return self._update(annotations)

    def _update(self, annotations: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        ann_np = {k: np.asarray(v) for k, v in annotations.items()}
        total = sum(int(v.shape[0]) for v in ann_np.values())
        if not ann_np:
            self._last_annotations = {}
            self.similarities = {}
            return self.similarities

        with span("session.dirty"):
            if self.dirty_tracking and self.similarities:
                dirty = [
                    k for k, v in ann_np.items()
                    if k not in self.similarities
                    or k not in self._last_annotations
                    or not np.array_equal(v, self._last_annotations[k])
                ]
            else:
                dirty = list(ann_np)

        sims = {k: self.similarities[k] for k in ann_np if k not in dirty}
        dirty_nonzero = {k: ann_np[k] for k in dirty if ann_np[k].shape[0] > 0}
        if dirty_nonzero:
            # the mean-first decision of the full class set, so that a
            # dirty-subset recompute is numerically identical
            new = self._compute(dirty_nonzero,
                                mean_first=(len(ann_np) == 1 and total > 1024))
            if self.largest_island:
                from vittf_tpu_torch.ops.connected import filter_similarity_largest_island

                new = {
                    k: filter_similarity_largest_island(v, self.island_threshold)
                    for k, v in new.items()
                }
            sims.update(new)
        # empty dirty classes (mid-annotation GUI state) serve zero maps, as
        # the full recompute gives for zero-count classes
        for k in dirty:
            if k not in sims:
                sims[k] = torch.zeros(self.sim_shape, dtype=torch.uint8, device=self.device)

        self._last_annotations = {k: v.copy() for k, v in ann_np.items()}
        self.similarities = {k: sims[k] for k in ann_np}
        return self.similarities

    def predict(self, thresholds=None) -> torch.Tensor:
        if not self.similarities:
            raise RuntimeError("No similarities yet — call update_annotations first")
        with span("session.predict", self.updates):
            return fuse_predictions(
                self.similarities, thresholds or _default_thresholds(len(self.similarities)))

    def export(self, data_dir: str | Path) -> None:
        """Write similarities + predictions per the artifact contract
        (atomic writes: frontends poll these files).

        Only maps that changed since the last export leave the device, as
        one stacked copy: with dirty tracking an unchanged class keeps the
        same tensor object, so its previously fetched host bytes are exact.
        The fused prediction is computed on the host from those bytes
        (``fuse_predictions_host``, bit-identical to the device fuse), so a
        one-class edit copies exactly one map."""
        with span("session.export"):
            self._export(Path(data_dir))

    def _export(self, data_dir: Path) -> None:
        names = list(self.similarities)
        if not names:  # cleared annotations: serve empty + background
            self._export_cache.clear()
            save_similarities(data_dir / "similarities.npy", {})
            save_array(data_dir / "predictions.npy", np.zeros(self.sim_shape, np.uint8))
            return
        fetch = [
            n for n in names
            if self._export_cache.get(n, (None,))[0] is not self.similarities[n]
        ]
        if fetch:
            stacked = torch.stack([self.similarities[n] for n in fetch])
            with span("sync.export"):
                stacked = stacked.cpu().numpy()
            for i, n in enumerate(fetch):
                self._export_cache[n] = (self.similarities[n], stacked[i])
        # drop classes that no longer exist (the cache would keep their
        # device tensors alive)
        for stale in set(self._export_cache) - set(names):
            del self._export_cache[stale]
        host_maps = {n: self._export_cache[n][1] for n in names}
        save_similarities(data_dir / "similarities.npy", host_maps)
        save_array(
            data_dir / "predictions.npy",
            fuse_predictions_host(host_maps, _default_thresholds(len(names))),
        )


class _INotify:
    """Minimal ctypes inotify watch on one directory (Linux only).

    A sleep-poll of ``annotations.npy`` adds half its interval to every
    frame's latency; inotify wakes the loop the moment the writer closes (or
    renames in) the file. Callers fall back to polling where inotify is
    unavailable."""

    # linux/inotify.h: writes complete on CLOSE_WRITE; atomic writers rename
    # a temp file in (MOVED_TO); CREATE covers fresh directories
    _MASK = 0x0008 | 0x0080 | 0x0100  # IN_CLOSE_WRITE | IN_MOVED_TO | IN_CREATE

    def __init__(self, directory: Path):
        import ctypes
        import ctypes.util

        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self.fd = self._libc.inotify_init1(os.O_NONBLOCK)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        wd = self._libc.inotify_add_watch(self.fd, os.fsencode(str(directory)), self._MASK)
        if wd < 0:
            err = ctypes.get_errno()
            os.close(self.fd)
            raise OSError(err, "inotify_add_watch failed")

    def wait(self, timeout: float) -> bool:
        """Block until a directory event or ``timeout`` seconds; drains the
        event queue (the caller re-checks the file's content either way)."""
        import select

        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return False
        try:
            while os.read(self.fd, 65536):
                pass
        except BlockingIOError:
            pass
        return True

    def close(self) -> None:
        os.close(self.fd)


def watch_directory(
    data_dir: str | Path,
    session: InteractiveSession,
    poll_interval: float = 0.25,
    max_updates: int | None = None,
    on_update=None,
    verbose: bool = True,
    use_inotify: bool = True,
) -> int:
    """Serve the artifact contract: on every ``annotations.npy`` change,
    recompute similarities and write ``similarities.npy``/``predictions.npy``.

    Change detection is event-driven (inotify) where available, with
    ``poll_interval`` as the fallback poll cadence (and the event-wait
    timeout). A change means the file's content changed: the bytes are hashed
    before parsing, so rewrites of identical annotations are skipped without
    recomputing anything.

    Returns the number of updates served (runs until interrupted when
    ``max_updates`` is None).
    """
    import hashlib
    import io

    data_dir = Path(data_dir)
    ann_path = data_dir / "annotations.npy"
    notifier = None
    if use_inotify:
        try:
            notifier = _INotify(data_dir)
        except Exception:
            notifier = None  # no inotify on this platform or filesystem: poll

    def wait():
        if notifier is not None:
            notifier.wait(poll_interval)
        else:
            time.sleep(poll_interval)

    last_digest: bytes | None = None
    served = 0
    try:
        while max_updates is None or served < max_updates:
            try:
                raw = ann_path.read_bytes()
            except OSError:
                raw = None
            digest = hashlib.blake2b(raw, digest_size=16).digest() if raw is not None else None
            if raw is None or digest == last_digest:
                wait()
                continue
            t0 = time.perf_counter()
            try:
                data = np.load(io.BytesIO(raw), allow_pickle=True)[()]
                annotations = {k: np.asarray(v) for k, v in data.items()}
            except Exception as e:  # partially written file: retry
                if verbose:
                    print(f"annotations read failed ({e}); retrying")
                wait()
                continue
            last_digest = digest
            session.update_annotations(annotations)
            session._synchronize()
            session.export(data_dir)
            served += 1
            dt = time.perf_counter() - t0
            if verbose:
                print(f"update {served}: {len(annotations)} classes in {dt*1e3:.0f}ms")
            if on_update:
                on_update(served, dt)
    finally:
        if notifier is not None:
            notifier.close()
    return served
