"""Port parity: vittf_tpu_torch.train (utils, losses, gather, moco, probe)
vs vittf_tpu.train on the same numpy inputs, on the CPU.

Losses at 1e-5 and their gradients (autograd against ``jax.grad``) at
1e-4; gathers, index helpers, augmentations fed the JAX draws, the MoCo queue
and its pointer exact; the probe's parameters after one and three AdamW
steps (``optax.adamw`` in JAX) at 1e-5 from the JAX twin's initial
parameters, on the batches of the same ``np.random.default_rng`` permutation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.train import gather as jg
from vittf_tpu.train import losses as jl
from vittf_tpu.train import moco as jm
from vittf_tpu.train import probe as jp
from vittf_tpu.train import utils as ju
from vittf_tpu_torch.models.cnn3d import params_from_jax
from vittf_tpu_torch.train import gather as tg
from vittf_tpu_torch.train import losses as tl
from vittf_tpu_torch.train import moco as tm
from vittf_tpu_torch.train import probe as tp
from vittf_tpu_torch.train import utils as tu

LOSS = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_(np.asarray(x).dtype == np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------- utils ----------------

def test_split_squeeze_indexes_like_jax(rng):
    vol = rng.standard_normal((2, 3, 5, 6, 7)).astype(np.float32)
    idx = np.stack([rng.integers(0, s, 9) for s in (5, 6, 7)], -1)
    want = np.asarray(jnp.asarray(vol)[ju.split_squeeze(jnp.asarray(idx), 2, 3)])
    got = torch.from_numpy(vol)[tu.split_squeeze(torch.from_numpy(idx), 2, 3)]
    assert got.shape == (2, 3, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    want3 = np.asarray(jnp.asarray(vol[0, 0])[ju.split_squeeze3d(jnp.asarray(idx))])
    np.testing.assert_array_equal(torch.from_numpy(vol[0, 0])[tu.split_squeeze3d(
        torch.from_numpy(idx))].numpy(), want3)


def test_kmeans_pca_meter_seed(rng, monkeypatch):
    feats = np.concatenate([rng.standard_normal((30, 6)) + 5 * c for c in range(3)]).astype(np.float32)
    np.testing.assert_array_equal(tu.cluster_kmeans(torch.from_numpy(feats), 3, seed=1),
                                  ju.cluster_kmeans(feats, 3, seed=1))
    np.testing.assert_allclose(tu.project_pca(torch.from_numpy(feats), 2),
                               ju.project_pca(feats, 2), rtol=1e-5, atol=1e-5)
    m_t, m_j = tu.AverageMeter(), ju.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 5)):
        m_t.update(v, n)
        m_j.update(v, n)
    assert (m_t.val, m_t.sum, m_t.count, m_t.avg) == (m_j.val, m_j.sum, m_j.count, m_j.avg)
    m_t.reset()
    assert m_t.count == 0 and m_t.avg == 0.0
    gen = tu.setup_seed_and_debug(11)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 11
    assert np.random.rand() == np.random.RandomState(11).rand()
    monkeypatch.setenv("CUDA_LAUNCH_BLOCKING", "0")
    try:
        tu.setup_seed_and_debug(3, debug=True)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# ---------------- gather ----------------

@pytest.mark.parametrize("ks", [3, 5])
def test_gather_receptive_fields_exact(rng, ks):
    vol = rng.random((2, 10, 11, 12)).astype(np.float32)
    centers = np.stack([rng.integers(0, s, 20) for s in (10, 11, 12)], axis=-1)
    want = np.asarray(jg.gather_receptive_fields(jnp.asarray(vol), jnp.asarray(centers), ks))
    got = tg.gather_receptive_fields(torch.from_numpy(vol), torch.from_numpy(centers), ks)
    assert got.shape == (20, 2, ks, ks, ks)
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.array([[0, 1, 2], [3, 4, 5]])
    np.testing.assert_array_equal(tg.upscale_indices(torch.from_numpy(idx), 4).numpy(),
                                  np.asarray(jg.upscale_indices(jnp.asarray(idx), 4)))


# ---------------- losses ----------------

def test_infonce_loss_and_gradient(rng):
    C, BS, N, Fd = 3, 4, 8, 16
    pos = rng.standard_normal((C, 2, BS, Fd)).astype(np.float32)
    neg = rng.standard_normal((C, N, 1, Fd)).astype(np.float32)
    want, (gp, gn) = jax.value_and_grad(jl.infonce_loss, argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    tpos, tneg = _t(pos), _t(neg)
    got = tl.infonce_loss(tpos, tneg)
    got.backward()
    _close(got, want, LOSS)
    _close(tpos.grad, gp, GRAD)
    _close(tneg.grad, gn, GRAD)


def test_feature_std_sharpen_snn(rng):
    f = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    _close(tl.feature_std(torch.from_numpy(f)), jl.feature_std(jnp.asarray(f)), LOSS)
    _close(tl.feature_std(torch.from_numpy(f), (0,), 0),
           jl.feature_std(jnp.asarray(f), (0,), 0), LOSS)
    p = rng.random((5, 3)).astype(np.float32)
    _close(tl.sharpen(torch.from_numpy(p), 0.25), jl.sharpen(jnp.asarray(p), 0.25), LOSS)
    q, s = rng.standard_normal((5, 8)).astype(np.float32), rng.standard_normal((7, 8)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 7)]
    _close(tl.snn(*map(torch.from_numpy, (q, s, lab))), jl.snn(*map(jnp.asarray, (q, s, lab))),
           LOSS)


@pytest.mark.parametrize("with_class", [False, True])
def test_paws_loss_and_gradient(rng, with_class):
    B, M, C, Fd = 6, 10, 3, 8
    av, tv = (rng.standard_normal((B, Fd)).astype(np.float32) for _ in range(2))
    sup = rng.standard_normal((M, Fd)).astype(np.float32)
    lab = np.eye(C, dtype=np.float32)[rng.integers(0, C, M)]
    clas = rng.standard_normal((M + B, C)).astype(np.float32) if with_class else None

    def jtotal(av, sup, tv, clas):
        out = jl.paws_loss(av, sup, jnp.asarray(lab), tv, sup, jnp.asarray(lab), clas_pred=clas)
        return sum(out), out

    args = [jnp.asarray(a) if a is not None else None for a in (av, sup, tv, clas)]
    argn = (0, 1, 2, 3) if with_class else (0, 1, 2)
    (_, want), grads = jax.value_and_grad(jtotal, argnums=argn, has_aux=True)(*args)
    targs = [_t(a) if a is not None else None for a in (av, sup, tv, clas)]
    got = tl.paws_loss(targs[0], targs[1], torch.from_numpy(lab), targs[2], targs[1],
                       torch.from_numpy(lab), clas_pred=targs[3])
    assert len(got) == len(want) == (3 if with_class else 2)
    sum(got).backward()
    for g, w in zip(got, want):
        _close(g, w, LOSS)
    for t, w in zip(targs, grads):  # the targets carry no gradient: None here, 0 in JAX
        _close(t.grad if t.grad is not None else torch.zeros_like(t), w, GRAD)
    assert targs[2].grad is None and not np.asarray(grads[2]).any()


@pytest.mark.parametrize("seed", range(6))
def test_transform_paws_crops_with_the_jax_draws(rng, seed):
    """The JAX key's noise, permutation and flips, read in the test, given
    to the port as draws: the same views, bit for bit."""
    crops = rng.standard_normal((3, 2, 5, 5, 5)).astype(np.float32)  # cubic: JAX's lax.switch
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jl.transform_paws_crops(jnp.asarray(crops), key))
    k1, k2, kp, kf = jax.random.split(key, 4)
    draws = {"noise": tuple(torch.from_numpy(np.array(jax.random.normal(k, crops.shape)))
                            for k in (k1, k2)),
             "perm": np.asarray(jax.random.randint(kp, (2,), 0, 6)).tolist(),
             "flips": (np.asarray(jax.random.uniform(kf, (6,))) < 0.5).tolist()}
    got = tl.transform_paws_crops(torch.from_numpy(crops), draws)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tl.transform_paws_crops(torch.from_numpy(crops), draws, noise_std=0.0, flip=False,
                                    permute=False)
    np.testing.assert_array_equal(plain.numpy(), np.concatenate([crops, crops]))


def test_transform_paws_crops_draws_from_a_generator():
    crops = torch.randn((2, 1, 5, 5, 5), generator=torch.Generator().manual_seed(0))
    a = tl.transform_paws_crops(crops, generator=torch.Generator().manual_seed(4))
    b = tl.transform_paws_crops(crops, generator=torch.Generator().manual_seed(4))
    assert a.shape == (4, 1, 5, 5, 5) and torch.equal(a, b)


# ---------------- moco ----------------

def test_moco_state_loss_and_queue_match_jax(rng):
    cfg_j, cfg_t = jm.MoCoConfig(dim=8, K=32, m=0.9, T=0.07), tm.MoCoConfig(dim=8, K=32, m=0.9, T=0.07)
    key = jax.random.PRNGKey(0)
    params = {"w": rng.standard_normal((3, 3)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32)]}
    js = jm.init_moco_state(jax.tree.map(jnp.asarray, params), key, cfg_j)
    raw = np.array(jax.random.normal(key, (8, 32)))
    ts = tm.init_moco_state(jax.tree.map(torch.from_numpy, params), cfg_t, queue=raw,
                            device="cpu")
    _close(ts["queue"], js["queue"], dict(rtol=1e-6, atol=1e-6))
    assert ts["queue_ptr"] == int(js["queue_ptr"]) == 0
    ts["queue"] = torch.from_numpy(np.asarray(js["queue"]).copy())
    for step in range(5):  # B·S = 8 keys a step: the pointer wraps after four
        qf, kf = (rng.standard_normal((2, 8, 4)).astype(np.float32) for _ in range(2))
        qf, kf = (v / np.linalg.norm(v, axis=1, keepdims=True) for v in (qf, kf))
        want, js = jm.moco_loss_and_new_state(js, jnp.asarray(qf), jnp.asarray(kf), cfg_j)
        got, ts = tm.moco_loss_and_new_state(ts, torch.from_numpy(qf), torch.from_numpy(kf), cfg_t)
        _close(got, want, LOSS)
        np.testing.assert_array_equal(ts["queue"].numpy(), np.asarray(js["queue"]))
        assert ts["queue_ptr"] == int(js["queue_ptr"]) == (8 * (step + 1)) % 32
        for a, b in zip(jax.tree.leaves(ts["params_k"]), jax.tree.leaves(js["params_k"])):
            _close(a, b, dict(rtol=1e-6, atol=1e-6))


def test_moco_loss_gradient_matches_jax(rng):
    cfg = jm.MoCoConfig(dim=8, K=16, T=0.07)
    queue = rng.standard_normal((8, 16)).astype(np.float32)
    qf, kf = (rng.standard_normal((2, 8, 3)).astype(np.float32) for _ in range(2))
    js = {"params_q": {}, "params_k": {}, "queue": jnp.asarray(queue), "queue_ptr": 0}
    want, gq = jax.value_and_grad(lambda q: jm.moco_loss_and_new_state(
        js, q, jnp.asarray(kf), cfg)[0])(jnp.asarray(qf))
    tq = _t(qf)
    ts = {"params_q": {}, "params_k": {}, "queue": torch.from_numpy(queue), "queue_ptr": 0}
    got, _ = tm.moco_loss_and_new_state(ts, tq, torch.from_numpy(kf), tm.MoCoConfig(8, 16, T=0.07))
    got.backward()
    _close(got, want, LOSS)
    _close(tq.grad, gq, GRAD)
    _close(tm.moco_logits(torch.from_numpy(qf), torch.from_numpy(kf), torch.from_numpy(queue), 0.07),
           jm.moco_logits(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(queue), 0.07), LOSS)


@pytest.mark.parametrize("ptr,B", [(0, 8), (24, 8), (20, 12), (28, 12)])
def test_dequeue_and_enqueue_exact(rng, ptr, B):
    """Columns replaced from the pointer, the start clamped where the keys
    would run past the end (``dynamic_update_slice``), the pointer mod K."""
    queue = rng.standard_normal((4, 32)).astype(np.float32)
    keys = rng.standard_normal((4, B)).astype(np.float32)
    wq, wp = jm.dequeue_and_enqueue(jnp.asarray(queue), jnp.asarray(ptr, jnp.int32),
                                    jnp.asarray(keys))
    tq = torch.from_numpy(queue.copy())
    gq, gp = tm.dequeue_and_enqueue(tq, ptr, torch.from_numpy(keys))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    assert gp == int(wp)
    np.testing.assert_array_equal(tq.numpy(), queue)  # the input queue is left as it was
    upd = tm.momentum_update({"w": torch.full((2,), 2.0)}, {"w": torch.ones(2)}, 0.9)
    np.testing.assert_allclose(upd["w"].numpy(), 0.9 * 1 + 0.1 * 2, rtol=1e-7)


# ---------------- probe ----------------

@pytest.mark.parametrize("hidden", [(), (16,)])
@pytest.mark.parametrize("steps", [1, 3])
def test_probe_trainer_steps_match_optax(rng, hidden, steps):
    """From the JAX twin's initial parameters: loss and parameters after one
    and three AdamW steps (lr 5e-3, weight decay 1e-2, eps 1e-8) at 1e-5."""
    n, f, C, bs = 16 * steps, 12, 3, 16
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, C, n)
    cfg_j = jp.ProbeConfig(hidden=hidden, learning_rate=5e-3, epochs=1, batch_size=bs)
    cfg_t = tp.ProbeConfig(hidden=hidden, learning_rate=5e-3, epochs=1, batch_size=bs)
    tr_j = jp.ProbeTrainer(f, C, cfg_j, seed=7)
    tr_t = tp.ProbeTrainer(f, C, cfg_t, seed=7, device="cpu",
                           params=params_from_jax(jax.tree.map(np.asarray, tr_j.params)))
    want_losses = tr_j.fit(x, y)
    got_losses = tr_t.fit(x, y)
    assert len(got_losses) == len(want_losses) == steps
    np.testing.assert_allclose(got_losses, want_losses, **LOSS)
    want = params_from_jax(jax.tree.map(np.asarray, tr_j.params))
    for lg, lw in zip(tr_t.params, want):
        for k in ("weight", "bias"):
            _close(lg[k], lw[k].numpy(), LOSS)
    fv = rng.standard_normal((f, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tr_t.predict_dense(torch.from_numpy(fv)).numpy(),
                                  np.asarray(tr_j.predict_dense(jnp.asarray(fv))))


def test_probe_forward_bce_and_init(rng):
    params = jp.init_probe(jp.ProbeConfig(hidden=(8,)), 6, 4, jax.random.PRNGKey(1))
    x = rng.standard_normal((5, 6)).astype(np.float32)
    yy = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
    port = params_from_jax(jax.tree.map(np.asarray, params))
    _close(tp.probe_forward(port, torch.from_numpy(x)), jp.probe_forward(params, jnp.asarray(x)),
           LOSS)
    _close(tp.bce_loss(port, torch.from_numpy(x), torch.from_numpy(yy)),
           jp.bce_loss(params, jnp.asarray(x), jnp.asarray(yy)), LOSS)
    mine = tp.init_probe(tp.ProbeConfig(hidden=(8,)), 6, 4, torch.Generator().manual_seed(0),
                         device="cpu")
    assert [tuple(l["weight"].shape) for l in mine] == [(8, 6), (4, 8)]
    assert all(l["weight"].abs().max() <= (1 / s) ** 0.5 for l, s in zip(mine, (6, 8)))


def test_probe_learns_on_separable_data(rng):
    n, f = 400, 16
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = (x @ rng.standard_normal((f, 3))).argmax(-1)
    tr = tp.ProbeTrainer(f, 3, tp.ProbeConfig(epochs=30, learning_rate=5e-3), seed=0,
                         device="cpu")
    losses = tr.fit(x, y)
    assert losses[-1] < losses[0] * 0.5
    pred = tr.predict_dense(torch.from_numpy(rng.standard_normal((f, 4, 4, 4)).astype(np.float32)))
    assert pred.shape == (4, 4, 4) and int(pred.max()) <= 3
