"""Port parity: vittf_tpu_torch.train.vit_ssl against vittf_tpu.train.vit_ssl,
on the CPU.

The port's step functions take their random draws as inputs; here they are
JAX's own draws, read from the keys as the JAX twin splits them
(``jax_view_draws``, ``jax_head_draws``), with the same initial parameters
(``params_from_jax``) and slice batches. One step of ``_supcon_step``,
``_ssl_step`` and ``_dino_step``: the loss within 1e-5, the step's
gradients (Adam's first moment) within 1e-5 of each leaf's largest and
finite, and the updated parameters (the DINO teacher too) within 1e-5 of
each leaf's largest value plus what Adam's first update makes of that
gradient tolerance where a gradient is near eps (``assert_first_step_close``);
the centre within 1e-5 of its largest. ``train_vit_selfsup`` runs each
method for 3 steps at ``tests/test_train_extras.py``'s settings (im_sz 16,
batch 4) with JAX's draws fed in: the host generators' states equal after
every step, the losses and parameters as ``test_train_vit_selfsup_matches_jax``
states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree
from vittf_tpu.models.vit import ViTConfig as JViTConfig
from vittf_tpu.models.vit import init_vit_params as jax_init
from vittf_tpu.train import vit_ssl as jv
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.models.vit import ViTConfig
from vittf_tpu_torch.train import vit_ssl as tv
from vittf_tpu_torch.train.optim import trainable, tree_leaves, tree_map_with_path

JCFG = JViTConfig(patch_size=8, embed_dim=48, depth=2, num_heads=3, name="tiny")
TCFG = ViTConfig(**dataclasses.asdict(JCFG))
SMALL = dict(im_sz=16, batch_slices=4)
DINO_SMALL = {**jv.VIT_SSL_ORACLE, **SMALL, "proto_k": 16, "proj_dim": 32, "bottleneck_dim": 16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    return jv.ViTSelfSupConfig(**kw), tv.ViTSelfSupConfig(**kw)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_view_draws(key, shape, cfg):
    """``_augment``'s draws from its key, as the port takes them."""
    k1, k2 = jax.random.split(key)
    gamma = None
    if cfg.gamma_jitter > 0.0:
        gamma = t(jax.random.uniform(k1, (shape[0], 1, 1, 1), minval=-1.0, maxval=1.0))
    return {"gamma": gamma, "noise": t(jax.random.normal(k2, shape))}


def jax_pair_draws(key, shape, cfg):
    ka, kb = jax.random.split(key)
    return jax_view_draws(ka, shape, cfg), jax_view_draws(kb, shape, cfg)


def jax_head_draws(key, dim, cfg):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"w1": t(jax.random.normal(k1, (dim, cfg.proj_dim))),
            "w2": t(jax.random.normal(k2, (cfg.proj_dim, cfg.bottleneck_dim))),
            "protos": t(jax.random.normal(k3, (cfg.proto_k, cfg.bottleneck_dim)))}


def flat(tree, prefix=""):
    """{path: ndarray} of a port tree (dicts of tensors) or a JAX one."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: np.array(tree.detach().cpu() if torch.is_tensor(tree) else tree)}


def to_port(tree):
    """A JAX tree ({'vit': params, 'head': ...} or params) in the port's layout."""
    if "vit" in tree:
        return {"vit": params_from_jax(as_numpy_tree(tree["vit"])),
                "head": {k: t(v) for k, v in tree["head"].items()}}
    return params_from_jax(as_numpy_tree(tree))


def grads_of(state) -> dict:
    """The first step's gradients from the optimizer state: Adam's first
    moment after one step is (1 − β₁)·g (a port ``AdamW`` or optax's
    ``adamw`` state)."""
    if isinstance(state, torch.optim.Optimizer):
        return {id(p): state.state[p]["exp_avg"] / 0.1 for p in state.param_groups[0]["params"]}
    return jax.tree.map(lambda m: np.asarray(m) / 0.1, state[0].mu)


def assert_leaves_close(got, want, frac=1e-5, what="params"):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=frac * scale, err_msg=f"{what} {k}")


def assert_first_step_close(got, want, grads, lr, frac=1e-5, mix=1.0, what="params"):
    """One AdamW step from equal values with gradients that agree within
    ``frac`` of each leaf's largest (held before this): the parameters agree
    within ``frac`` of each leaf's largest value, plus, entry by entry, what
    the first Adam update lr·g/(|g| + eps) makes of that gradient tolerance
    (lr·eps·δg/(|g| + eps)², at most 2·lr; ``mix`` scales it for the DINO
    teacher's EMA). It only matters where |g| is near eps: there Adam turns
    rounding into a step of up to ±lr (the k thirds of the qkv biases of the
    blocks before the last, whose gradient softmax cancels, are such)."""
    g, w, dg = flat(got), flat(want), flat(grads)
    eps = 1e-8
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        d = frac * float(np.abs(dg[k]).max())
        amp = np.minimum(lr * eps * d / (np.abs(dg[k]) + eps) ** 2, 2 * lr)
        ulp = np.spacing(np.abs(w[k]).astype(g[k].dtype))
        bad = np.abs(g[k] - w[k]) > frac * scale + mix * amp + 2 * ulp
        assert not bad.any(), (what, k, int(bad.sum()), float(np.abs(g[k] - w[k]).max()))


def check_gradients(topt, tparams, jstate):
    """The port's first-step gradients within 1e-5 of each leaf's largest
    of JAX's, and finite; returns JAX's in the port's layout."""
    tg = grads_of(topt)
    port = tree_map_with_path(lambda _, x: tg[id(x)], tparams)
    for x in tree_leaves(port):
        assert torch.isfinite(x).all()
    want = to_port(grads_of(jstate) if "vit" not in tparams else
                   {"vit": grads_of(jstate)["vit"], "head": grads_of(jstate)["head"]})
    assert_leaves_close(port, want, what="gradient")
    return want

@pytest.fixture(scope="module")
def jparams():
    p = jax_init(JCFG, jax.random.PRNGKey(0))
    # non-trivial biases and norms, so that every leaf's gradient counts
    leaves, tree = jax.tree.flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    return jax.tree.unflatten(tree, [a + 0.02 * jax.random.normal(k, a.shape)
                                     for a, k in zip(leaves, keys)])


def batches(seed, cfg, labels=False):
    rng = np.random.default_rng(seed)
    vol = rng.random((24, 24, 24)).astype(np.float32)
    lab = rng.integers(0, 3, (24, 24, 24)).astype(np.uint8) if labels else None
    if labels:
        lab[:, :, 12:] = 0
        lab[3, 5, 20] = 4  # a class of one voxel: a token with no positive
    return jv._slice_batch(vol, cfg, rng, labels=lab, patch=JCFG.patch_size)


def test_supcon_step_matches_jax(jparams):
    jcfg, tcfg = cfgs(method="supcon", **SMALL)
    ba, _, tok = batches(1, jcfg, labels=True)
    tok[0, :3] = 4  # one class of 3 tokens, one of a single token (npos 0)
    tok[1, 0] = 5
    key = jax.random.PRNGKey(3)
    opt = optax.adamw(jcfg.learning_rate, weight_decay=jcfg.weight_decay)
    want, jstate, jloss = jv._supcon_step(jparams, opt.init(jparams), jnp.asarray(ba),
                                          jnp.asarray(tok), key, JCFG, jcfg, opt)
    params = trainable(to_port(jparams), "cpu")
    topt = tv.make_optimizer(params, tcfg)
    got, topt, loss = tv._supcon_step(params, topt, t(ba), t(tok), jax_view_draws(key, ba.shape, jcfg),
                                      TCFG, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = check_gradients(topt, got, jstate)
    assert_first_step_close(got, to_port(want), grads, tcfg.learning_rate)


def test_ssl_step_matches_jax(jparams):
    jcfg, tcfg = cfgs(**SMALL)
    ba, bb, _ = batches(2, jcfg)
    key = jax.random.PRNGKey(4)
    opt = optax.adamw(jcfg.learning_rate, weight_decay=jcfg.weight_decay)
    want, jstate, jloss = jv._ssl_step(jparams, opt.init(jparams), jnp.asarray(ba),
                                       jnp.asarray(bb), key, JCFG, jcfg, opt)
    params = trainable(to_port(jparams), "cpu")
    topt = tv.make_optimizer(params, tcfg)
    got, topt, loss = tv._ssl_step(params, topt, t(ba), t(bb), *jax_pair_draws(key, ba.shape, jcfg),
                                   TCFG, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = check_gradients(topt, got, jstate)
    assert_first_step_close(got, to_port(want), grads, tcfg.learning_rate)


@pytest.mark.parametrize("gamma", [0.0, 0.3], ids=["oracle", "gamma"])
def test_dino_step_matches_jax(jparams, gamma):
    jcfg, tcfg = cfgs(**{**DINO_SMALL, "gamma_jitter": gamma})
    ba, bb, _ = batches(3, jcfg)
    hk, key = jax.random.split(jax.random.PRNGKey(5))
    student = {"vit": jparams, "head": jv._init_dino_head(hk, JCFG.embed_dim, jcfg)}
    # a teacher and a centre that differ from the student, as after a few steps
    teacher = jax.tree.map(lambda a: a * 1.01, student)
    center = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (jcfg.proto_k,))
    opt = optax.adamw(jcfg.learning_rate, weight_decay=jcfg.weight_decay)
    want_s, want_t, jstate, want_c, jloss = jv._dino_step(
        student, teacher, opt.init(student), center, jnp.asarray(ba), jnp.asarray(bb), key,
        JCFG, jcfg, opt)
    head = tv._init_dino_head(jax_head_draws(hk, JCFG.embed_dim, jcfg), JCFG.embed_dim, tcfg)
    assert_leaves_close(head, flat(student["head"]), what="head init")
    s = trainable(to_port(student), "cpu")
    tt = {k: {n: v.detach().clone() for n, v in d.items()} for k, d in to_port(teacher).items()}
    topt = tv.make_optimizer(s, tcfg)
    got_s, got_t, topt, got_c, loss = tv._dino_step(
        s, tt, topt, t(center), t(ba), t(bb), *jax_pair_draws(key, ba.shape, jcfg), TCFG, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = check_gradients(topt, got_s, jstate)
    assert_first_step_close(got_s, to_port(want_s), grads, tcfg.learning_rate)
    assert_first_step_close(got_t, to_port(want_t), grads, tcfg.learning_rate,
                            mix=1.0 - tcfg.ema, what="teacher")
    assert_leaves_close({"c": got_c}, {"c": np.asarray(want_c)}, what="centre")


def jax_key_stream(method, seed, steps, shape, cfg):
    """The draws JAX's ``train_vit_selfsup`` makes, in its order: the head's
    (dino) and each step's views."""
    key = jax.random.PRNGKey(seed)
    head = None
    if method == "dino":
        key, hk = jax.random.split(key)
        head = jax_head_draws(hk, JCFG.embed_dim, cfg)
    views = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        views += ([jax_view_draws(sub, shape, cfg)] if method == "supcon"
                  else list(jax_pair_draws(sub, shape, cfg)))
    return head, views


def recording(fn, states):
    def wrapped(vol, cfg, rng, *a, **kw):
        out = fn(vol, cfg, rng, *a, **kw)
        states.append(rng.bit_generator.state)
        return out
    return wrapped


def run_both(monkeypatch, method, jparams, steps=3):
    """``train_vit_selfsup`` for ``steps`` steps in both packages from the
    same values, slices and draws (JAX's, fed to the port); the host
    generators' states after every step must be equal. Returns both results."""
    kw = DINO_SMALL if method == "dino" else {**SMALL, "method": method}
    jcfg, tcfg = cfgs(**{**kw, "steps": steps})
    rng = np.random.default_rng(7)
    vol = rng.random((24, 24, 24)).astype(np.float32)
    labels = rng.integers(0, 4, (24, 24, 24)).astype(np.uint8) if method == "supcon" else None
    head, views = jax_key_stream(method, 0, steps, (4, 1, 16, 16), jcfg)
    views = iter(views)
    monkeypatch.setattr(tv, "head_draws", lambda gen, dim, cfg: head)
    monkeypatch.setattr(tv, "augment_draws", lambda gen, shape, cfg: next(views))
    jstates, tstates = [], []
    monkeypatch.setattr(jv, "_slice_batch", recording(jv._slice_batch, jstates))
    monkeypatch.setattr(tv, "_slice_batch", recording(tv._slice_batch, tstates))
    want, jhist = jv.train_vit_selfsup(vol, jparams, JCFG, jcfg, seed=0, log_every=1,
                                       labels=labels)
    got, thist = tv.train_vit_selfsup(vol, to_port(jparams), TCFG, tcfg, seed=0, log_every=1,
                                      labels=labels, device="cpu")
    assert len(jstates) == len(tstates) == steps and jstates == tstates
    assert next(views, None) is None  # every draw was taken
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == list(range(steps))
    assert np.isfinite([h["loss"] for h in thist]).all()
    assert set(got) == set(to_port(jparams)) and not any(v.requires_grad for v in got.values())
    return (got, thist), (to_port(want), jhist), tcfg


@pytest.mark.parametrize("method", ["infonce", "supcon", "dino"])
def test_train_vit_selfsup_matches_jax(jparams, monkeypatch, method):
    """Three steps run free. Adam turns the rounding of gradients near zero
    into steps of up to ±lr (``assert_first_step_close``), and the two
    packages' LayerNorms both take fp32 statistics (under jax x64 too, so a
    float64 run does not take the rounding away, as it did for PAWS): the
    losses are held within 1e-4 (1.2e-5 apart at step 3 for infonce), the
    parameters within 1e-5 of each leaf's largest value, but for the k
    thirds of the qkv biases of the blocks before the last (softmax cancels
    their gradient), held within three updates of 2·lr."""
    (got, thist), (want, jhist), tcfg = run_both(monkeypatch, method, jparams)
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-4)
    g, w = flat(got), flat(want)
    k_third = slice(JCFG.embed_dim, 2 * JCFG.embed_dim)
    for k in w:
        gk, wk = g[k], w[k]
        if k in [f"blocks.{i}.attn.qkv.bias" for i in range(JCFG.depth - 1)]:
            assert np.abs(gk[k_third] - wk[k_third]).max() <= 3 * 2 * tcfg.learning_rate, k
            gk, wk = np.delete(gk, k_third), np.delete(wk, k_third)
        np.testing.assert_allclose(gk, wk, rtol=0, atol=1e-5 * float(np.abs(wk).max()),
                                   err_msg=k)


def test_train_vit_selfsup_runs_on_its_own_draws():
    """The port's own draws (a torch.Generator): the loss is finite, the
    parameters move, the result feeds extraction, and a second run with the
    same seed repeats it bit for bit."""
    from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

    params = to_port(jax_init(JCFG, jax.random.PRNGKey(0)))
    vol = np.random.default_rng(0).random((24, 24, 24)).astype(np.float32)
    cfg = tv.ViTSelfSupConfig(**{**DINO_SMALL, "steps": 2})
    runs = [tv.train_vit_selfsup(vol, params, TCFG, cfg, seed=0, device="cpu") for _ in range(2)]
    (got, hist), (again, _) = runs
    assert np.isfinite(hist[-1]["loss"])
    last = f"blocks.{TCFG.depth - 1}.attn.qkv.weight"
    assert not torch.equal(got[last], params[last])
    assert all(torch.equal(got[k], again[k]) for k in got)
    feats = extract_features(vol, got, TCFG, ExtractConfig(feature_output_size=4, batch_size=4),
                             device="cpu")["k"]
    assert feats.shape == (48, 4, 4, 4) and torch.isfinite(feats).all()
    with pytest.raises(ValueError, match="labels"):
        tv.train_vit_selfsup(vol, params, TCFG, tv.ViTSelfSupConfig(method="supcon", **SMALL),
                             device="cpu")


def test_oracle_preset_and_config_match_jax():
    assert tv.VIT_SSL_ORACLE == jv.VIT_SSL_ORACLE
    assert dataclasses.asdict(tv.ViTSelfSupConfig()) == dataclasses.asdict(jv.ViTSelfSupConfig())
    assert len(tree_leaves({"a": torch.zeros(1), "b": {"c": torch.zeros(1)}})) == 2


ORACLE_STEPS = 30


def test_oracle_preset_trajectory_matches_jax(jparams, monkeypatch):
    """``VIT_SSL_ORACLE`` at the small size for 30 steps in both packages
    from the same values, slices and draws: the witness that the port's
    DINO trajectory follows the JAX trainer's where the oracle preset
    collapses (the loss climbs to ln(proto_k), a uniform teacher: 1.96 to
    2.91 against ln 16 = 2.77 here). Every step's loss within 1e-5 of
    JAX's (1.5e-6 apart at most when written)."""
    (_, thist), (_, jhist), tcfg = run_both(monkeypatch, "dino", jparams, steps=ORACLE_STEPS)
    tl, jl = np.array([h["loss"] for h in thist]), np.array([h["loss"] for h in jhist])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ln_k = np.log(tcfg.proto_k)
    assert abs(jl[-1] - ln_k) < 0.25 * abs(jl[0] - ln_k)  # JAX's own run collapses
