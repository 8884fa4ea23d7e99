"""Port parity: vittf_tpu_torch.parallel.pipeline_parallel on 2 and 3 gloo
ranks of the CPU.

The cases of ``tests/test_pipeline_parallel.py``: the staged blocks on as
many stages as ranks (``tests/torch_dist_helper.py``), with several
microbatch counts and with LayerScale, match the sequential forward (the
port's ``forward_raw`` and JAX's ``vit_forward``) within 1e-4 on every
rank, the depth 2·ranks so that it divides; the stacking shapes and the two
refusals (a depth the stages do not divide, a batch the microbatches do
not divide).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.torch_dist_helper import run_ranks
from vittf_tpu.models.vit import ViTConfig, init_vit_params, vit_forward
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.models.vit import VisionTransformer
from vittf_tpu_torch.parallel.pipeline_parallel import pp_vit_forward, stack_block_params

MICRO = {2: (2, 4), 3: (3, 2)}  # microbatch counts per world size


def _cfg(world, layerscale=False):
    return ViTConfig(patch_size=4, embed_dim=32, depth=2 * world, num_heads=4, img_size=16,
                     layerscale=layerscale)


def _params(cfg, seed, loud=True):
    params = init_vit_params(cfg, jax.random.PRNGKey(seed))
    if loud:  # non-trivial weights
        params = jax.tree.map(
            lambda a: a + 0.03 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    return params


@pytest.fixture(scope="module", params=[2, 3], ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory):
    world = request.param
    batch = 2 * world
    x = np.random.default_rng(0).standard_normal((batch, 3, 16, 16)).astype(np.float32)
    cases = {f"micro{m}": (_cfg(world), 7, m, True) for m in MICRO[world]}
    cases["layerscale"] = (_cfg(world, layerscale=True), 2, 2, False)
    jparams = {n: _params(cfg, seed, loud) for n, (cfg, seed, _, loud) in cases.items()}
    inputs = {"pp": {n: (params_from_jax(as_numpy_tree(jparams[n])), dataclasses.asdict(cfg),
                         torch.from_numpy(x), m)
                     for n, (cfg, _, m, _) in cases.items()}}
    outs = run_ranks(world, inputs, tmp_path_factory.mktemp(f"pp{world}"))
    return world, outs, cases, jparams, x


@pytest.mark.parametrize("case", ["micro0", "micro1", "layerscale"])
def test_pp_forward_matches_sequential(ranks, case):
    world, outs, cases, jparams, x = ranks
    name = {"micro0": f"micro{MICRO[world][0]}", "micro1": f"micro{MICRO[world][1]}"}.get(case, case)
    cfg = cases[name][0]
    want_tok, want_qkv = vit_forward(jparams[name], jnp.asarray(x), cfg, precision="highest",
                                     attn_impl="xla")
    model = VisionTransformer.from_state_dict(port_cfg(cfg),
                                              params_from_jax(as_numpy_tree(jparams[name])))
    tok, qkv = model.forward_raw(torch.from_numpy(x), precision="highest", attn_impl="plain")
    for out in outs:
        got_tok, got_qkv = out["pp"][name]
        for g, p, w in ((got_tok, tok, want_tok), (got_qkv, qkv, want_qkv)):
            assert g.shape == p.shape == w.shape
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got_tok, outs[0]["pp"][name][0], rtol=0, atol=0)


def test_pp_rejects_bad_microbatching(ranks):
    """A batch the microbatches do not divide is refused on the ranks; and
    before any collective, so that no mesh is needed to see it."""
    _, outs, _, _, _ = ranks
    assert all("not divisible by 2 microbatches" in o["pp"]["refused"] for o in outs)
    params = params_from_jax(as_numpy_tree(init_vit_params(_cfg(2), jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="microbatches"):
        pp_vit_forward(params, torch.zeros((3, 3, 16, 16)), port_cfg(_cfg(2)), None, n_micro=2)


def test_stack_block_params_shapes():
    params = params_from_jax(as_numpy_tree(init_vit_params(_cfg(2), jax.random.PRNGKey(0))))
    stacked = stack_block_params(params, 2)
    assert stacked["attn.qkv.weight"].shape == (2, 2, 96, 32)
    assert torch.equal(stacked["mlp.fc2.bias"][1, 0], params["blocks.2.mlp.fc2.bias"])
    with pytest.raises(ValueError, match="not divisible"):
        stack_block_params(params, 3)
