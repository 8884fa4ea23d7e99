"""Port parity: vittf_tpu_torch.train.{contrastive,intra_clr} against their
vittf_tpu twins, on the CPU.

Both trainers are built with the same seed; the port starts from the JAX
twin's initial parameters (``models.cnn3d.params_from_jax``) and draws its
host indices from its own ``np.random.default_rng(seed)``: the generators
must stay in step (the same centres). IntraCLR's augmentation draws are
read from the JAX key as its step splits it and handed to the port. The
step's record (loss and aux) at every step within 1e-5 through step 3 and
1e-4 after, the parameters after 1 and 3 steps within 1e-5 and after 10
within 1e-4 (past RAdam's rectification threshold, under the one-cycle and
cosine schedules), RAdam's moments beside them. Then the short runs in
which the JAX tests see the loss fall, on the port alone.
"""
import jax
import numpy as np
import pytest
import torch

from vittf_tpu.models.cnn3d import FeatureExtractorConfig as JFC
from vittf_tpu.train import contrastive as jc
from vittf_tpu.train import intra_clr as ji
from vittf_tpu_torch.models.cnn3d import FeatureExtractorConfig as TFC
from vittf_tpu_torch.models.cnn3d import params_from_jax
from vittf_tpu_torch.train import contrastive as tc
from vittf_tpu_torch.train import intra_clr as ti
from vittf_tpu_torch.train.optim import tree_map_with_path

EARLY = dict(rtol=1e-5, atol=1e-5)  # through step 3
LATE = dict(rtol=1e-4, atol=1e-4)  # step 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (150 small steps took 2 s alone, 32 s
    beside three other workers with torch's default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(step):
    return EARLY if step <= 3 else LATE


def to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def by_path(tree) -> dict:
    """{path: ndarray copy} of a port-layout tree."""
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, np.array(t.detach().cpu())), tree)
    return out


def assert_trees_close(got, want, tol):
    g, w = by_path(got), by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=str(k), **tol)


def assert_records_close(got: dict, want: dict, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def key_draws(key, shape):
    """The trainer's ``key, sub = split(key)`` and ``transform_paws_crops``'
    split of ``sub``, as the port's draws; returns (next key, draws)."""
    key, sub = jax.random.split(key)
    k1, k2, kp, kf = jax.random.split(sub, 4)
    draws = {"noise": tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                            for k in (k1, k2)),
             "perm": np.asarray(jax.random.randint(kp, (2,), 0, 6)).tolist(),
             "flips": (np.asarray(jax.random.uniform(kf, (6,))) < 0.5).tolist()}
    return key, draws


def radam_state_by_path(port_params, port_state, jax_state):
    """RAdam's (mu, nu) of both trainers as {path: array}, the port's in
    the order of its parameter leaves."""
    radam_t = port_state[-1][0] if isinstance(port_state[-1], tuple) else port_state[0]
    paths = list(by_path(port_params))
    radam_j = [s for s in jax.tree.leaves(jax_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")][0]
    got = {("mu",) + p: m for p, m in zip(paths, radam_t.mu)}
    got.update({("nu",) + p: v for p, v in zip(paths, radam_t.nu)})
    want = {("mu",) + p: a for p, a in by_path(to_port(radam_j.mu)).items()}
    want.update({("nu",) + p: a for p, a in by_path(to_port(radam_j.nu)).items()})
    return got, want, int(radam_j.count), radam_t.count


def two_class_volume(rng, size=16):
    labels = np.zeros((size,) * 3, np.uint8)
    labels[2:8, 2:8, 2:8] = 1
    labels[9:15, 9:15, 9:15] = 2
    vol = (labels == 1) * 0.9 + (labels == 2) * 0.1
    return (vol + rng.random(vol.shape) * 0.02).astype(np.float32), labels


@pytest.mark.parametrize("variant", [
    dict(schedule="onecycle", lambda_std=0.1, weight_decay=1e-3),
    dict(schedule="cosine", lambda_std=0.1, std_loss_on="cosine", rec_field=5),
])
def test_contrastive_trainer_matches_jax(rng, variant):
    vol, labels = two_class_volume(rng)
    rec_field = variant.pop("rec_field", 3)
    n_feat = (8,) if rec_field == 3 else (8, 8)
    common = dict(rec_field=rec_field, batch_size=4, neg_count=16, learning_rate=1e-2,
                  iterations=10, **variant)
    tj = jc.ContrastiveTrainer(vol, labels, jc.ContrastiveConfig(JFC(1, n_feat, (8,)), **common),
                               seed=0)
    tt = tc.ContrastiveTrainer(vol, labels, tc.ContrastiveConfig(TFC(1, n_feat, (8,)), **common),
                               seed=0, device="cpu", params=to_port(tj.params))
    assert tt.class_indices.keys() == tj.class_indices.keys()
    for step in range(1, 11):
        want, got = tj.step(), tt.step()
        assert tt.rng.bit_generator.state == tj.rng.bit_generator.state
        assert_records_close(got, want, _tol(step))
        if step in (1, 3, 10):
            assert_trees_close(tt.params, to_port(tj.params), _tol(step))
    got, want, n_j, n_t = radam_state_by_path(tt.params, tt.opt_state, tj.opt_state)
    assert n_j == n_t == 10
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=str(k), **LATE)
    feats = tt.dense_features()
    assert feats.shape == (8, 16, 16, 16)
    np.testing.assert_allclose(feats.numpy(), np.asarray(tj.dense_features()), **LATE)


def test_contrastive_from_rle_annotations_matches_jax(rng):
    from vittf_tpu.core.rle import encode_to_annotation

    vol, labels = two_class_volume(rng)
    runs = encode_to_annotation(labels, {1: "a", 2: "b"})
    ann = {"b": runs["b"], "empty": np.zeros(0, np.int64), "a": runs["a"]}
    cfg = dict(rec_field=3, batch_size=4, neg_count=16, iterations=2)
    tj = jc.ContrastiveTrainer.from_rle_annotations(
        vol, ann, jc.ContrastiveConfig(JFC(1, (8,), (8,)), **cfg), seed=1)
    tt = tc.ContrastiveTrainer.from_rle_annotations(
        vol, ann, tc.ContrastiveConfig(TFC(1, (8,), (8,)), **cfg), seed=1, device="cpu",
        params=to_port(tj.params))
    assert tt.class_names == tj.class_names == {1: "b", 2: "a"}
    for c in tj.class_indices:
        np.testing.assert_array_equal(tt.class_indices[c], tj.class_indices[c])
    assert_records_close(tt.step(), tj.step(), EARLY)


def test_contrastive_make_optimizer_tiny_iterations_no_nan():
    """Below four iterations the one-cycle schedule is NaN: the factory
    takes a constant rate, as the twin's does."""
    opt = tc.make_optimizer(tc.ContrastiveConfig(iterations=1))
    p = [torch.ones(3)]
    upd, _ = opt.update([torch.ones(3)], opt.init(p), p)
    assert torch.isfinite(upd[0]).all()


@pytest.mark.parametrize("schedule", ["cosine", "onecycle"])
def test_intra_clr_trainer_matches_jax(rng, schedule):
    vol = rng.random((14, 14, 14)).astype(np.float32)
    common = dict(rec_field=3, batch_size=8, learning_rate=3e-3, schedule=schedule,
                  iterations=10, weight_decay=1e-3)
    tj = ji.IntraCLRTrainer(vol, ji.IntraCLRConfig(JFC(1, (8,), (8,)), **common), seed=0)
    tt = ti.IntraCLRTrainer(vol, ti.IntraCLRConfig(TFC(1, (8,), (8,)), **common), seed=0,
                            device="cpu", params=to_port(tj.params))
    key = tj.key
    for step in range(1, 11):
        key, draws = key_draws(key, (8, 1, 3, 3, 3))
        want, got = tj.step(), tt.step(draws)
        assert tt.rng.bit_generator.state == tj.rng.bit_generator.state
        np.testing.assert_allclose(got, want, **_tol(step))
        if step in (1, 3, 10):
            assert_trees_close(tt.params, to_port(tj.params), _tol(step))


def test_contrastive_trainer_learns(rng):
    """The JAX test's setting: two well-separated classes, 150 steps; the
    InfoNCE loss approaches its floor ln(1 + N·e⁻²) at perfect separation."""
    vol, labels = two_class_volume(rng)
    cfg = tc.ContrastiveConfig(model=TFC(1, (8,), (8,)), rec_field=3, batch_size=8,
                               neg_count=32, learning_rate=1e-2, schedule="const",
                               iterations=150)
    trainer = tc.ContrastiveTrainer(vol, labels, cfg, seed=0, device="cpu")
    first = trainer.step()["infonce"]
    for _ in range(149):
        last = trainer.step()["infonce"]
    floor = float(np.log(1 + 32 * np.exp(-2.0)))
    assert first > floor + 1.0 and last < floor + 0.1, (first, last, floor)
    assert trainer.dense_features().shape[-3:] == vol.shape


def test_intra_clr_loss_decreases(rng):
    vol = rng.random((14, 14, 14)).astype(np.float32)
    cfg = ti.IntraCLRConfig(model=TFC(1, (8,), (8,)), rec_field=3, batch_size=16,
                            learning_rate=3e-3, schedule="const", iterations=40)
    tr = ti.IntraCLRTrainer(vol, cfg, seed=0, device="cpu")
    losses = [tr.step() for _ in range(40)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_trainers_refuse_silent_cpu(monkeypatch, rng):
    """No CUDA device and no ``device``: the trainers raise, never train on
    the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol, labels = two_class_volume(rng, 12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.ContrastiveTrainer(vol, labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ti.IntraCLRTrainer(vol)
