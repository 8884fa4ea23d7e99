"""Port parity: vittf_tpu_torch.models.cnn3d vs vittf_tpu.models.cnn3d.

The JAX twin's initial parameters, carried across by ``params_from_jax``,
and the same numpy crops go through both forwards: fp32 on the CPU at 1e-5
(convolution and GroupNorm sums in another order). The PAWSNet heads' batch
norm is held in train and eval mode, with its running statistics after a
step, and on a batch of one row, where torch's own ``batch_norm`` refuses to
train.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.models import cnn3d as jc
from vittf_tpu_torch.models import cnn3d as tc

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n_linear", [(16,), (16, 16)])
def test_feature_extractor_forward_matches_jax(rng, residual, n_linear):
    cfg_j = jc.FeatureExtractorConfig(1, (8, 16), n_linear, residual=residual)
    cfg_t = tc.FeatureExtractorConfig(1, (8, 16), n_linear, residual=residual)
    params = jc.init_feature_extractor(cfg_j, jax.random.PRNGKey(0))
    x = rng.standard_normal((2, 1, 9, 9, 9)).astype(np.float32)
    want = jc.feature_extractor_forward(params, jnp.asarray(x), cfg_j, precision="highest")
    got = tc.feature_extractor_forward(tc.params_from_jax(_np(params)), torch.from_numpy(x), cfg_t)
    assert got.shape == want.shape == (2, 16, 5, 5, 5)
    _close(got, want)


def test_feature_extractor_without_norm_and_init_shapes(rng):
    cfg_j = jc.FeatureExtractorConfig(2, (4, 8), (8,), norm="none")
    cfg_t = tc.FeatureExtractorConfig(2, (4, 8), (8,), norm="none")
    params = jc.init_feature_extractor(cfg_j, jax.random.PRNGKey(1))
    x = rng.standard_normal((3, 2, 7, 8, 9)).astype(np.float32)
    want = jc.feature_extractor_forward(params, jnp.asarray(x), cfg_j, precision="highest")
    port = tc.params_from_jax(_np(params))
    _close(tc.feature_extractor_forward(port, torch.from_numpy(x), cfg_t), want)
    # a seeded init has the converted tree's structure, shapes and bounds
    mine = tc.init_feature_extractor(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    assert [(p, v.shape) for p, v in flat(mine)[0]] == [(p, v.shape) for p, v in flat(port)[0]]
    w = mine["convs"][0]["conv"]["weight"]
    assert w.abs().max() <= (1.0 / (2 * 27)) ** 0.5 and w.std() > 0


def test_mish_and_group_norm_match_jax(rng):
    x = (rng.standard_normal((2, 8, 3, 4, 5)) * 4).astype(np.float32)
    _close(tc.mish(torch.from_numpy(x)), jc.mish(jnp.asarray(x)))
    s, b = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    _close(tc.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 2),
           jc.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 2))


def _paws(seed=0):
    cfg_j = jc.PAWSNetConfig(1, (8, 16, 32), 64, 3)
    cfg_t = tc.PAWSNetConfig(1, (8, 16, 32), 64, 3)
    params, state = jc.init_pawsnet(cfg_j, jax.random.PRNGKey(seed))
    # move the BN affines and running stats off their init so that each counts
    r = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * r.standard_normal(v.shape).astype(np.float32)
        if "bn" in jax.tree_util.keystr(p) else v, _np(params))
    state = jax.tree.map(lambda v: np.abs(v + 0.2 * r.standard_normal(v.shape)).astype(np.float32),
                         _np(state))
    return cfg_j, cfg_t, params, state


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("class_pred", [False, True])
def test_pawsnet_forward_and_bn_state_match_jax(rng, train, class_pred):
    """Outputs at 1e-5 and the BN state after the step (train: running
    averages moved by the batch; eval: unchanged)."""
    cfg_j, cfg_t, params, state = _paws()
    x = rng.standard_normal((6, 1, 7, 7, 7)).astype(np.float32)
    want, want_s = jc.pawsnet_forward(jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, state), jnp.asarray(x), cfg_j,
                                      train=train, return_class_pred=class_pred)
    got, got_s = tc.pawsnet_forward(tc.params_from_jax(params), tc.params_from_jax(state),
                                    torch.from_numpy(x), cfg_t, train=train,
                                    return_class_pred=class_pred)
    assert len(got) == len(want) == (3 if class_pred else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    flat_w = jax.tree_util.tree_flatten_with_path(_np(want_s))[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got_s)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (p, w), (_, g) in zip(flat_w, flat_g):
        _close(g, w)
    if not train:
        assert got_s["proj"]["bn0"]["mean"] is not None
        _close(got_s["proj"]["bn1"]["var"], state["proj"]["bn1"]["var"], rtol=0, atol=0)


def test_batch_norm_of_one_row_matches_jax(rng):
    """One row in training: batch variance 0, running variance scaled by
    n / max(n − 1, 1) = 1, where ``F.batch_norm`` raises."""
    x = rng.standard_normal((1, 5)).astype(np.float32)
    p = {"scale": rng.standard_normal(5).astype(np.float32), "bias": np.zeros(5, np.float32)}
    s = {"mean": np.full(5, 0.3, np.float32), "var": np.full(5, 2.0, np.float32)}
    want_y, want_s = jc._batch_norm(jnp.asarray(x), p, s, True)
    got_y, got_s = tc._batch_norm(torch.from_numpy(x), tc.params_from_jax(p),
                                  tc.params_from_jax(s), True)
    _close(got_y, want_y)
    for k in ("mean", "var"):
        _close(got_s[k], want_s[k])
    with pytest.raises(ValueError):
        torch.nn.functional.batch_norm(torch.from_numpy(x), None, None, training=True)
    cfg_j, cfg_t, params, state = _paws()
    crop = rng.standard_normal((1, 1, 7, 7, 7)).astype(np.float32)
    (wf, _), _ = jc.pawsnet_forward(params, state, jnp.asarray(crop), cfg_j, train=True)
    (gf, _), _ = tc.pawsnet_forward(tc.params_from_jax(params), tc.params_from_jax(state),
                                    torch.from_numpy(crop), cfg_t, train=True)
    _close(gf, wf)


def test_pawsnet_gradients_match_jax(rng):
    """A loss over all three heads: autograd against ``jax.grad`` at 1e-4 of
    the largest gradient (the first convolution's gradient sums thousands of
    products through three layers and five-row batch norms; the encoder's
    last bias, whose gradient the batch norm after it cancels, is ~1e-7),
    the class head's gradient kept out of the encoder on both sides."""
    cfg_j, cfg_t, params, state = _paws(2)
    x = rng.standard_normal((5, 1, 7, 7, 7)).astype(np.float32)

    def jloss(prm):
        (f, p, c), _ = jc.pawsnet_forward(prm, jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                                          cfg_j, train=True, return_class_pred=True)
        return (f ** 2).mean() + jnp.sin(p).sum() + (c * jnp.arange(3.0)).sum()

    want = _np(jax.grad(jloss)(jax.tree.map(jnp.asarray, params)))
    tp = tc.params_from_jax(params)
    leaves = [v.requires_grad_(True) for v in jax.tree.leaves(tp)]
    (f, p, c), _ = tc.pawsnet_forward(tp, tc.params_from_jax(state), torch.from_numpy(x), cfg_t,
                                      train=True, return_class_pred=True)
    ((f ** 2).mean() + torch.sin(p).sum() + (c * torch.arange(3.0)).sum()).backward()
    got = tc.params_from_jax(jax.tree.map(np.zeros_like, params))
    grads = iter(v.grad for v in leaves)
    got = jax.tree.map(lambda _: next(grads), got)
    want_t = jax.tree_util.tree_flatten_with_path(tc.params_from_jax(want))[0]
    scale = max(float(w.abs().max()) for _, w in want_t)
    for (path, w), g in zip(want_t, jax.tree.leaves(got)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
