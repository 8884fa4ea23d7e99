"""Port parity: vittf_tpu_torch.models.serialization and cli.convert_weights
vs vittf_tpu. Flat-key ``.npz`` files written by either package load in the
other, value for value; the weight converter writes the JAX package's
layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import port_cfg
from tests.test_vit import TINY, _make_pair
from vittf_tpu.models import serialization as jser
from vittf_tpu.models.dino import load_dino_checkpoint as jax_load_dino
from vittf_tpu_torch.cli import convert_weights
from vittf_tpu_torch.models import dino as tdino
from vittf_tpu_torch.models import serialization as tser


def _tree(rng):
    return {"blocks": [{"qkv": {"kernel": rng.standard_normal((4, 12)).astype(np.float32),
                                "bias": rng.standard_normal(12).astype(np.float32)}}
                       for _ in range(3)],
            "norm": {"scale": np.ones(4, np.float32)},
            "step": np.int32(7)}


def _assert_same(port_tree, jax_tree):
    flat_p, flat_j = tser.flatten_params(port_tree), jser.flatten_params(jax_tree)
    assert sorted(flat_p) == sorted(flat_j)
    for k in flat_j:
        assert flat_p[k].dtype == flat_j[k].dtype, k
        np.testing.assert_array_equal(flat_p[k], flat_j[k])


def test_npz_loads_in_both_directions(tmp_path, rng):
    """A file the JAX package writes loads in the port (CPU tensors, lists
    where the keys are digits), and one the port writes from tensors loads
    in the JAX package, every leaf equal."""
    tree = _tree(rng)
    jser.save_params_npz(tmp_path / "jax.npz", jax.tree.map(jnp.asarray, tree))
    got = tser.load_params_npz(tmp_path / "jax.npz")
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == 3
    assert torch.is_tensor(got["blocks"][2]["qkv"]["kernel"])
    _assert_same(got, tree)

    port_tree = jax.tree.map(torch.from_numpy, jax.tree.map(np.asarray, tree))
    tser.save_params_npz(tmp_path / "port.npz", port_tree)
    _assert_same(tser.load_params_npz(tmp_path / "port.npz"), tree)
    _assert_same(port_tree, jser.load_params_npz(tmp_path / "port.npz"))
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)


def test_flatten_unflatten_round_trip(rng):
    tree = tser.unflatten_params(jser.flatten_params(_tree(rng)))
    assert tser.unflatten_params(tser.flatten_params(tree)).keys() == tree.keys()
    _assert_same(tree, _tree(np.random.default_rng(0)))


def test_checkpoint_round_trip_latest_step(tmp_path):
    """``torch.save`` checkpoints of params + optimizer state + step; the
    latest step when none is given; a missing directory raises."""
    w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    opt = torch.optim.AdamW([w], lr=1e-2)
    w.sum().backward()
    opt.step()
    for step in (3, 10, 7):
        tser.save_checkpoint(tmp_path / "ck", {"params": {"w": w.detach() * step},
                                               "opt": opt.state_dict(), "step": step}, step)
    assert tser.checkpoint_steps(tmp_path / "ck") == [3, 7, 10]
    latest = tser.restore_checkpoint(tmp_path / "ck")
    assert latest["step"] == 10
    torch.testing.assert_close(latest["params"]["w"], w.detach() * 10, rtol=0, atol=0)
    assert tser.restore_checkpoint(tmp_path / "ck", step=3)["step"] == 3
    opt2 = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2, 3))], lr=1e-2)
    opt2.load_state_dict(latest["opt"])
    torch.testing.assert_close(opt2.state_dict()["state"][0]["exp_avg"],
                               opt.state_dict()["state"][0]["exp_avg"], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        tser.restore_checkpoint(tmp_path / "none")


def test_params_to_jax_inverts_params_from_jax():
    tmodel, params = _make_pair(TINY)
    back = tdino.params_to_jax(tdino.params_from_jax(jax.tree.map(np.asarray, params)))
    _assert_same(back, jax.tree.map(np.asarray, params))


def test_convert_weights_writes_the_jax_layout(tmp_path, capsys, monkeypatch):
    """A DINO ``.pth`` (written here from a tiny ViT) → ``.npz`` through the
    port's CLI; the JAX package loads it and gets what its own converter
    makes of the same ``.pth``; the port's ``infer`` path loads it back into
    the ``.pth``'s tensors."""
    tmodel, _ = _make_pair(TINY)
    pth = tmp_path / "ckpt.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in tmodel.state_dict().items()}}, pth)
    monkeypatch.setitem(tdino.ALL_ARCHS, "tiny", port_cfg(TINY))
    assert convert_weights.main([str(pth), str(tmp_path / "w.npz"), "--arch", "tiny"]) == 0
    assert "depth=" in capsys.readouterr().out
    want = jax.tree.map(np.asarray, jax_load_dino(pth, TINY))
    _assert_same(jax.tree.map(np.asarray, jser.load_params_npz(tmp_path / "w.npz")), want)
    sd = tdino.params_from_jax(tser.load_params_npz(tmp_path / "w.npz"))
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
