"""Each traffic mix end to end at a tiny size on the CPU, through the
program's plain twins; its control, and the program broken underneath, come
out not correct under the real cells' limits."""
import time

import pytest
import torch

from portbench import control
from portbench.harness import edit, extract
from portbench.harness.outcome import limit_checks
from portbench.tests import tiny

SEED = 2**33 + 17  # more than 32 bits, as a run's seed may be


def run_extract(cell, seconds=0.5):
    return extract.run(cell, SEED, seconds, False, time.perf_counter(), device="cpu")


def run_edit(cell, seconds=0.5):
    return edit.run(cell, SEED, seconds, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("block_impl,workload", [("fused", "vits8-extract-256"),
                                                 ("xla", "vitb8-extract-256")])
def test_extract_runs_and_is_correct(block_impl, workload):
    out = run_extract(tiny.extract_cell(block_impl, workload))
    assert out.correct and out.attempted >= 1 and out.end_to_end["extract_mvox_s"] > 0
    key = "fused_block" if block_impl == "fused" else "attention"
    assert out.work[key][0][0] == out.attempted * 8 * (tiny.MODEL["depth"] - 1)


@pytest.mark.parametrize("refined,workload", [(True, "vits8-edit-refined-256"),
                                              (False, "vitb8-edit-plain-256")])
def test_edit_runs_and_is_correct(refined, workload):
    out = run_edit(tiny.edit_cell(refined, workload))
    assert out.correct and out.attempted >= 1
    assert 0 < out.end_to_end["edit_p50_ms"] <= out.end_to_end["edit_p95_ms"]
    assert {c.name for c in out.checks} == {"maps_differ", "fuse_differ"}


def test_same_seed_same_inputs():
    cell = tiny.edit_cell()
    a = edit.make_inputs(cell, SEED, torch.device("cpu"))
    b = edit.make_inputs(cell, SEED, torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for _ in range(7):
        a[2].edit(), b[2].edit()
    assert all((a[2].state[n] == b[2].state[n]).all() for n in a[2].names)


def test_extract_control_is_not_correct():
    values = control.extract_control(tiny.extract_cell(), SEED, torch.device("cpu"))
    assert not all(c.ok for c in limit_checks(values, tiny.limits("vits8-extract-256")))


@pytest.mark.parametrize("refined,workload", [(True, "vits8-edit-refined-256"),
                                              (False, "vitb8-edit-plain-256")])
def test_edit_control_is_not_correct(refined, workload):
    cell = tiny.edit_cell(refined, workload)
    values = control.edit_control(cell, SEED, torch.device("cpu"), 40)
    assert not all(c.ok for c in limit_checks(values, cell.limits))


# ---- the timed path broken underneath: each fault a cell can have


def _extract_fault(kind):
    from vittf_tpu_torch.pipeline import features

    real = features._slice_batch_features

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        if kind == "unchanged":  # the accumulators come back as they went in
            return [torch.zeros_like(f) for f in out]
        half = out[0].shape[0] // 2
        if kind == "half_batch":  # half the batch left out, the mean of the rest in its place
            return [torch.cat([f[:half], f[:half].mean(0, keepdim=True).expand_as(f[half:])])
                    for f in out]
        return [torch.cat([f[:half], -f[half:half + 1], f[half + 1:]]) for f in out]  # altered
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_extract_faults_are_caught(monkeypatch, kind):
    from vittf_tpu_torch.pipeline import features

    monkeypatch.setattr(features, "_slice_batch_features", _extract_fault(kind))
    assert not run_extract(tiny.extract_cell()).correct


EDIT_FAULTS = ("unchanged", "half_batch", "altered")


def plant_edit_fault(monkeypatch, kind):
    """Break the session underneath a run: each fault an edit cell can have."""
    from vittf_tpu_torch.pipeline import session

    real_update, real_predict = (session.InteractiveSession.update_annotations,
                                 session.InteractiveSession.predict)

    def update(self, annotations):
        if kind == "unchanged" and self.similarities:  # the edit leaves the maps as they were
            return self.similarities
        if kind == "half_batch":  # half of each class's annotations left out
            annotations = {k: v[: len(v) // 2] for k, v in annotations.items()}
        return real_update(self, annotations)

    def predict(self, thresholds=None):
        pred = real_predict(self, thresholds)
        if kind == "altered":  # one voxel's label altered where the labels are produced
            pred = pred.clone()
            pred[0, 0, 0] = (pred[0, 0, 0] + 1) % 6
        return pred

    monkeypatch.setattr(session.InteractiveSession, "update_annotations", update)
    monkeypatch.setattr(session.InteractiveSession, "predict", predict)


@pytest.mark.parametrize("kind", EDIT_FAULTS)
def test_edit_faults_are_caught(monkeypatch, kind):
    plant_edit_fault(monkeypatch, kind)
    assert not run_edit(tiny.edit_cell()).correct


# ---- on the card: the controls at the cells' own sizes


@pytest.mark.card
@pytest.mark.parametrize("workload", ["vits8-extract-256", "vits8-edit-refined-256",
                                      "vitb8-extract-256", "vitb8-edit-plain-256"])
def test_control_at_cell_size_is_not_correct(card, workload):
    from portbench.harness import spec

    cell = spec.load_cell(workload)
    if cell.traffic["loop"] == "extract":
        values = control.extract_control(cell, SEED, card)
    else:
        values = control.edit_control(cell, SEED, card, 1000)
    assert not all(c.ok for c in limit_checks(values, cell.limits))


@pytest.mark.card
@pytest.mark.parametrize("kind", EDIT_FAULTS)
@pytest.mark.parametrize("workload", ["vits8-edit-refined-256", "vitb8-edit-plain-256"])
def test_edit_faults_at_cell_size_are_caught(card, monkeypatch, workload, kind):
    from portbench.harness import spec

    plant_edit_fault(monkeypatch, kind)
    out = edit.run(spec.load_cell(workload), SEED, 2.0, False, time.perf_counter())
    assert not out.correct
