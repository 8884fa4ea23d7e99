"""Port parity: vittf_tpu_torch.train.paws against its vittf_tpu twin, on
the CPU, held as ``test_torch_train_contrastive`` holds the crop trainers:
the same seed, the JAX twin's parameters and BatchNorm state, host draws in
step, the augmentation draws read from the JAX key; records at every step,
parameters, BatchNorm state and the LARS / SGD traces after 1, 3 and 10
steps. The LARS / SGD partition leaf by leaf, the JAX test's setting, and
the small-iteration NaN copied from the twin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_contrastive import (
    EARLY,
    _tol,
    assert_records_close,
    assert_trees_close,
    by_path,
    key_draws,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    to_port,
)
from tests.test_torch_train_dense import LABELS, toy_data
from vittf_tpu.models.cnn3d import PAWSNetConfig as JPC
from vittf_tpu.models.cnn3d import init_pawsnet
from vittf_tpu.train import paws as jpw
from vittf_tpu_torch.models.cnn3d import PAWSNetConfig as TPC
from vittf_tpu_torch.models.cnn3d import params_from_jax
from vittf_tpu_torch.train import paws as tpw
from vittf_tpu_torch.train.optim import tree_leaves, tree_map_with_path, trainable


# ---------------- PAWS ----------------

def test_lars_labels_match_jax_leaf_by_leaf():
    """The port's trees name a norm scale ``weight`` (a conv kernel too):
    the labels come from the path, and give JAX's partition at every leaf."""
    jparams, _ = init_pawsnet(jpw.PAWSConfig().model, jax.random.PRNGKey(0))
    want = by_path(to_port(jax.tree.map(lambda s: np.float32(s == "lars"),
                                        jpw._lars_label_fn(jparams))))
    got = tpw._lars_label_fn(to_port(jparams))
    flat = {}
    tree_map_with_path(lambda p, s: flat.__setitem__(p, s), got)
    assert flat.keys() == want.keys()
    assert {p: s == "lars" for p, s in flat.items()} == {p: bool(v) for p, v in want.items()}
    # 4 conv, 1 linear-conv and the last conv weights; 7 linear weights of the heads
    assert sum(s == "lars" for s in flat.values()) == 13
    assert flat[("encoder", "convs", "0", "norm", "weight")] == "exclude"
    assert flat[("encoder", "convs", "0", "conv", "weight")] == "lars"


def _paws_pair(rng, schedule, iterations=10, lr=5e-3, size=16, hidden=64, M=8, BS=32):
    vol, mask = toy_data(rng, size)
    mask = mask.copy()
    mask[0:2] = 3  # unlabeled voxels (class 3 = num_classes)
    common = dict(supports_per_class=M, batch_size=BS, learning_rate=lr, schedule=schedule,
                  iterations=iterations)
    tj = jpw.PAWSTrainer(vol, mask, LABELS,
                         jpw.PAWSConfig(model=JPC(1, (8, 8), hidden, out_classes=3), **common),
                         seed=0)
    tt = tpw.PAWSTrainer(vol, mask, LABELS,
                         tpw.PAWSConfig(model=TPC(1, (8, 8), hidden, out_classes=3), **common),
                         seed=0, device="cpu", params=to_port(tj.params),
                         bn_state=to_port(tj.bn_state))
    return vol, tj, tt


def test_paws_trainer_matches_jax(rng):
    """Ten steps at 32 anchors, 8 supports a class, hidden 64 and lr 5e-3.
    (At the JAX test's 6 anchors, 4 supports, hidden 16 and lr 0.05 the
    BatchNorm heads see 20 rows and the conv biases take gradients of ~20:
    fp32 rounding, which the heads amplify, parts the two runs beyond 1e-5
    within three steps; in float64 the same ten steps agree within 1e-9,
    ``test_paws_trainer_matches_jax_in_float64``.)"""
    vol, tj, tt = _paws_pair(rng, "onecycle")
    key = tj.key
    for step in range(1, 11):
        key, draws = key_draws(key, (32, 1, 5, 5, 5))
        want, got = tj.step(), tt.step(draws)
        assert tt.rng.bit_generator.state == tj.rng.bit_generator.state
        assert_records_close(got, want, _tol(step))
        if step in (1, 3, 10):
            assert_trees_close(tt.params, to_port(tj.params), _tol(step))
            assert_trees_close(tt.bn_state, to_port(tj.bn_state), _tol(step))
    # the momentum traces: LARS's holds lr-scaled updates, SGD's raw
    # gradients, held at 1e-3 of each leaf's largest (the gradients' fp32
    # rounding, as in the next test)
    paths = list(by_path(tt.params))
    labels = tree_leaves(tpw._lars_label_fn(tt.params))
    for group in ("lars", "exclude"):
        mine = [p for p, lab in zip(paths, labels) if lab == group]
        trace_t = tt.opt_state[group][-1] if group == "lars" else tt.opt_state[group][0]
        jstate = tj.opt_state.inner_states[group].inner_state
        jtrace = jstate[-1].trace if group == "lars" else jstate[0].trace
        want = by_path(to_port(jtrace))
        assert len(mine) == len(trace_t)
        for p, t in zip(mine, trace_t):  # SGD's holds gradient sums of up to ~10
            np.testing.assert_allclose(t.numpy(), want[p], rtol=0,
                                       atol=1e-4 + 1e-3 * np.abs(want[p]).max(), err_msg=str(p))
    # argmax over the class head: a near-tie may fall the other way
    differ = (tt.predict_dense().numpy() != np.asarray(tj.predict_dense())).mean()
    assert differ <= 1e-3, differ


def _paws_pair_float64(rng):
    """``_paws_pair`` at the JAX test's setting (12³, 6 anchors, 4 supports
    a class, hidden 16, lr 0.05), both trainers moved to float64 from the
    same initial values; call inside ``jax.enable_x64(True)``."""
    _, tj, tt = _paws_pair(rng, "const", lr=0.05, size=12, hidden=16, M=4, BS=6)
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    tj.params, tj.bn_state, tj.vol4 = f64(tj.params), f64(tj.bn_state), f64(tj.vol4)
    tj.opt_state = tj.opt.init(tj.params)
    double = lambda t: tree_map_with_path(lambda _, x: x.detach().double(), t)  # noqa: E731
    tt.params = trainable(double(tt.params), "cpu")
    tt.bn_state, tt.vol4 = double(tt.bn_state), tt.vol4.double()
    tt.opt_state = tt.opt.init(tree_leaves(tt.params))
    return tj, tt


def test_paws_trainer_matches_jax_in_float64(rng):
    """The JAX test's setting, ten steps, both packages in float64 (jax x64,
    torch.double): records at every step, parameters, BatchNorm state and
    the LARS / SGD traces after 1, 3 and 10 steps within 1e-9. In fp32 the
    same run parts by 2e-2 in a record by step 4 (the next test holds its
    first step), so that parting is fp32 rounding amplified by the BatchNorm
    heads over 20 rows, not a difference of the port (ROADMAP §C 14)."""
    tol = dict(rtol=1e-9, atol=1e-9)
    with jax.enable_x64(True):
        tj, tt = _paws_pair_float64(rng)
        key = tj.key
        for step in range(1, 11):
            key, draws = key_draws(key, (6, 1, 5, 5, 5))
            assert draws["noise"][0].dtype == torch.float64
            assert_records_close(tt.step(draws), tj.step(), tol)
            if step in (1, 3, 10):
                for got, want in ((tt.params, tj.params), (tt.bn_state, tj.bn_state)):
                    assert_trees_close(got, params_from_jax(jax.tree.map(np.asarray, want),
                                                            dtype=np.float64), tol)
        paths = list(by_path(tt.params))
        labels = tree_leaves(tpw._lars_label_fn(tt.params))
        for group in ("lars", "exclude"):
            trace_t = tt.opt_state[group][-1] if group == "lars" else tt.opt_state[group][0]
            jstate = tj.opt_state.inner_states[group].inner_state
            jtrace = jstate[-1].trace if group == "lars" else jstate[0].trace
            want = by_path(params_from_jax(jax.tree.map(np.asarray, jtrace), dtype=np.float64))
            mine = [p for p, lab in zip(paths, labels) if lab == group]
            assert len(mine) == len(trace_t)
            for p, t in zip(mine, trace_t):
                assert t.dtype == torch.float64
                np.testing.assert_allclose(t.numpy(), want[p], err_msg=str(p), **tol)


def test_paws_first_step_at_the_jax_test_config(rng):
    """The JAX test's setting (12³, 6 anchors, 4 supports, hidden 16, lr
    0.05): the first step's record within 1e-5, and its update (lr times
    the gradient under SGD, trust-scaled under LARS) within 1e-3 of each
    leaf's largest move (fp32 rounding through BatchNorm over 20 rows puts
    the gradients 1.2e-4 of it apart)."""
    _, tj, tt = _paws_pair(rng, "const", lr=0.05, size=12, hidden=16, M=4, BS=6)
    before_t, before_j = by_path(tt.params), by_path(to_port(tj.params))
    _, draws = key_draws(tj.key, (6, 1, 5, 5, 5))
    assert_records_close(tt.step(draws), tj.step(), EARLY)
    after_t, after_j = by_path(tt.params), by_path(to_port(tj.params))
    for k in before_j:
        move_t, move_j = after_t[k] - before_t[k], after_j[k] - before_j[k]
        np.testing.assert_allclose(move_t, move_j, rtol=0,
                                   atol=1e-3 * np.abs(move_j).max() + 1e-7, err_msg=str(k))


def test_paws_trainer_runs_and_predicts(rng):
    """The JAX test's setting on the port alone (losses finite, a dense
    prediction of the volume's shape), and the small-iteration NaN copied:
    one-cycle at 3 iterations NaNs every update, as in the twin."""
    vol, mask = toy_data(rng)
    mask = mask.copy()
    mask[0:2] = 3
    cfg = tpw.PAWSConfig(model=TPC(1, (8, 8), 16, out_classes=3), supports_per_class=4,
                         batch_size=6, learning_rate=0.05, schedule="const", iterations=10)
    tr = tpw.PAWSTrainer(vol, mask, LABELS, cfg, seed=0, device="cpu")
    losses = [tr.step()["loss"] for _ in range(5)]
    assert all(np.isfinite(losses))
    assert tr.predict_dense().shape == vol.shape
    _, tj, tt = _paws_pair(rng, "onecycle", iterations=3, size=12, hidden=16, M=4, BS=6)
    tt.step()
    assert all(torch.isnan(p).all() for p in tree_leaves(tt.params))
    tj.step()
    assert all(np.isnan(np.asarray(p)).all() for p in jax.tree.leaves(tj.params))
