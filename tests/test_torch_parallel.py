"""Port parity: vittf_tpu_torch.parallel.{mesh,extract} and the infer CLI's
``--data-parallel`` on 2 and 3 gloo ranks of the CPU.

Each case of ``tests/test_parallel.py`` runs on the ranks
(``tests/torch_dist_helper.py``: the ranks import only torch and the port),
and every rank's result is held against the single-process port path and
the JAX function on the same numpy inputs: sharded extraction and
similarity within 1e-5 (the ranks' partial sums are added in another order
than one process adds them), the tensor-parallel forward within 1e-4 (JAX's
TP tolerance). Every rank holds the same result, bit for bit. The port has no
``pool_slice_axis`` option: its single-axis fast-mode case keeps the slice
axis unpooled, as ``ExtractConfig`` pools it only in the 'all' sweep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import as_numpy_tree, port_cfg
from tests.test_vit import TINY, _make_pair
from tests.torch_dist_helper import run_ranks
from vittf_tpu.models.vit import ViTConfig as JViTConfig
from vittf_tpu.models.vit import init_vit_params, vit_forward
from vittf_tpu.ops.similarity import class_mean_matrix, similarity_xla
from vittf_tpu.pipeline.features import ExtractConfig as JEx
from vittf_tpu.pipeline.features import extract_features as jax_extract
from vittf_tpu_torch.models.dino import params_from_jax
from vittf_tpu_torch.models.vit import VisionTransformer
from vittf_tpu_torch.ops.similarity import similarity_plain
from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features

WORLDS = [2, 3]
COMMON = dict(feature_output_size=4, batch_size=2, precision="highest")
EXTRACT = {  # name → (volume shape, seed, config beyond COMMON)
    "noncubic_all": ((12, 16, 20), 1, dict(slice_along="all")),
    "cubic_all_fused": ((16, 16, 16), 2, dict(slice_along="all")),
    "fast_fused_padded": ((12, 12, 12), 3, dict(slice_along="all", slice_subsample=True)),
    "single_axis_fast": ((16, 16, 16), 4, dict(slice_along="z", slice_subsample=True)),
}
# TP: a width whose heads split over the ranks (4 heads over 2, 6 over 3)
TP_CFG = {2: TINY, 3: JViTConfig(patch_size=4, embed_dim=48, depth=2, num_heads=6, img_size=16,
                                 name="tiny6")}


@pytest.fixture(scope="module")
def tiny_params():
    return _make_pair(TINY, seed=3)[1]


def _volume(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _similarity_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (N, F, counts, kw) in {
        "two_classes": (777, 16, [5, 9], {}),  # N divisible by neither 2 nor 3
        "mean_first": (512, 8, [1500], {"mean_first": True}),
    }.items():
        scale = 0.2 if kw else 0.3
        feats = (rng.standard_normal((N, F)) * scale).astype(np.float32)
        qf = (rng.standard_normal((sum(counts), F)) * (0.1 if kw else 0.3)).astype(np.float32)
        m = class_mean_matrix(counts, sum(counts))
        out[name] = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (feats, qf, m)) + (kw,)
    return out


def _loud_params(cfg, seed):
    """JAX ``init_vit_params`` with every leaf moved, so each term counts."""
    p = init_vit_params(cfg, jax.random.PRNGKey(seed))
    leaves, tree = jax.tree.flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.unflatten(tree, [a + 0.03 * jax.random.normal(k, a.shape)
                                     for a, k in zip(leaves, keys)])


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, tiny_params, tmp_path_factory):
    """Every case on ``world`` ranks, once per module: (world, outputs of each
    rank, the inputs)."""
    world = request.param
    sd = params_from_jax(as_numpy_tree(tiny_params))
    tp = _loud_params(TP_CFG[world], 7)
    images = np.random.default_rng(5).standard_normal((2, 3, 16, 16)).astype(np.float32)
    inputs = {
        "mesh": {},
        "extract": {"vit": dataclasses.asdict(TINY), "params": sd,
                    "cases": {n: (_volume(s, seed), {**COMMON, **kw})
                              for n, (s, seed, kw) in EXTRACT.items()}},
        "similarity": _similarity_inputs(),
        "tp": {"vit": dataclasses.asdict(TP_CFG[world]), "images": torch.from_numpy(images),
               "params": params_from_jax(as_numpy_tree(tp))},
    }
    outs = run_ranks(world, inputs, tmp_path_factory.mktemp(f"dist{world}"))
    return world, outs, {**inputs, "tp_jax": tp, "images": images}


def _same_on_every_rank(outs, case):
    first = outs[0][case]
    for other in outs[1:]:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     first, other[case])
    return first


def test_make_mesh_shapes(ranks):
    world, outs, _ = ranks
    got = _same_on_every_rank(outs, "mesh")
    assert got["data"] == {"dcn": 1, "data": world, "model": 1}
    assert got["default"] == got["data"]
    assert got["model"] == {"dcn": 1, "data": 1, "model": world}
    assert f"needs {4 * world} devices, have {world}" in got["refused"]


def test_make_mesh_needs_a_process_group():
    from vittf_tpu_torch.parallel.mesh import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_sharded_extraction_takes_each_ranks_device(monkeypatch):
    """No device given: the first card in a world of one, ``cuda:LOCAL_RANK``
    among several ranks, and a refusal when no LOCAL_RANK says which; a
    given device is taken as it is."""
    from vittf_tpu_torch.parallel import extract

    monkeypatch.setattr(extract.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert extract._rank_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="pass this rank's device"):
        extract._rank_device(None)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert extract._rank_device(None) == torch.device("cuda", 1)
    monkeypatch.setattr(extract.dist, "get_world_size", lambda group=None: 1)
    assert extract._rank_device(None) == torch.device("cuda", 0)


@pytest.mark.parametrize("case", list(EXTRACT))
def test_sharded_extraction_matches_single_device(ranks, tiny_params, case):
    _, outs, inputs = ranks
    got = _same_on_every_rank(outs, "extract")[case]
    vol, kw = inputs["extract"]["cases"][case]
    plain = extract_features(vol, inputs["extract"]["params"], port_cfg(TINY),
                             ExtractConfig(**kw), device="cpu")["k"]
    want = np.asarray(jax_extract(jnp.asarray(vol), tiny_params, TINY,
                                  JEx(attn_impl="xla", **kw))["k"])
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["two_classes", "mean_first"])
def test_sharded_similarity_matches_single_device(ranks, case):
    _, outs, inputs = ranks
    got = _same_on_every_rank(outs, "similarity")[case]
    f, q, m, kw = inputs["similarity"][case]
    plain = similarity_plain(f, q, m, **kw)
    want = np.asarray(similarity_xla(jnp.asarray(f.numpy()), jnp.asarray(q.numpy()),
                                     jnp.asarray(m.numpy()), **kw))
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_tensor_parallel_vit_forward(ranks):
    """Heads split by head within each of q, k and v: each rank holds whole
    heads; the forward matches the replicated one (the port's and JAX's)."""
    world, outs, inputs = ranks
    got = _same_on_every_rank(outs, "tp")
    cfg = TP_CFG[world]
    assert got["qkv_rows"] == 3 * cfg.embed_dim // world
    x = inputs["images"]
    want_tok, want_qkv = vit_forward(inputs["tp_jax"], jnp.asarray(x), cfg,
                                     precision="highest", attn_impl="xla")
    model = VisionTransformer.from_state_dict(port_cfg(cfg), inputs["tp"]["params"])
    tok, qkv = model.forward_raw(torch.from_numpy(x), precision="highest", attn_impl="plain")
    for g, p, w in ((got["tokens"], tok, want_tok), (got["qkv"], qkv, want_qkv)):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_param_shardings_split_heads():
    """The qkv split takes rank r's rows of each of q, k and v; the row
    products' biases stay whole (added once after the all-reduce)."""
    from vittf_tpu_torch.parallel.mesh import _local, vit_param_shardings

    sd = params_from_jax(as_numpy_tree(init_vit_params(TINY, jax.random.PRNGKey(0))))
    s = vit_param_shardings(sd, None)
    assert s["blocks.1.attn.qkv.weight"] == "column_heads"
    assert s["blocks.0.attn.proj.bias"] == s["blocks.0.mlp.fc2.bias"] == "replicate"
    assert s["blocks.0.mlp.fc1.bias"] == "column" and s["blocks.0.mlp.fc2.weight"] == "row"
    assert s["pos_embed"] == "replicate"
    w = torch.arange(3 * 8).reshape(3 * 8, 1)
    assert _local(w, "column_heads", 2, 1).flatten().tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


def test_infer_data_parallel_over_ranks(tmp_path):
    """``infer --cpu --data-parallel`` on 2 ranks started with torchrun's
    environment (the CLI joins the gloo group itself): rank 0 writes an
    artifact within 1e-5 of the plain CLI's (fp32 artifacts, parity mode)."""
    from vittf_tpu_torch.cli import infer

    np.save(tmp_path / "v.npy", np.random.default_rng(1).random((16, 16, 16), dtype=np.float32))
    args = ["--data-path", str(tmp_path / "v.npy"), "--feature-output-size", "4",
            "--precision", "highest", "--feature-dtype", "float32", "--cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert infer.main(args + ["--cache-path", str(tmp_path / "plain.npy")]) == 0
    finally:
        torch.set_num_threads(threads)
    outs = run_ranks(2, {"cli": {"args": args + ["--data-parallel", "--cache-path",
                                                 str(tmp_path / "dp.npy")]}},
                     tmp_path / "ranks", env_init=True)
    assert [o["cli"] for o in outs] == [{"rc": 0, "world": 2, "backend": "gloo"}] * 2
    want = np.load(tmp_path / "plain.npy", allow_pickle=True)[()]["k"]
    got = np.load(tmp_path / "dp.npy", allow_pickle=True)[()]["k"]
    assert got.dtype == np.float32 and got.shape == want.shape == (384, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
