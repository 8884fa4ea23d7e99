"""Port parity: vittf_tpu_torch.ops.connected and the native union-find loader
vs vittf_tpu on CPU. Labels, masks and filtered maps are integers: every
comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import connected as jcc
from vittf_tpu_torch import native
from vittf_tpu_torch.ops import connected as tcc


def _masks(rng):
    spiral = np.zeros((4, 30, 30), bool)  # long thin island: pointer jumping
    spiral[1, 1, 1:29] = spiral[1, 1:29, 28] = spiral[1, 28, 5:28] = True
    spiral[3, 0, 0] = True
    tie = np.zeros((6, 6, 6), bool)  # two islands of equal size
    tie[0:2, 0:2, 0:2] = tie[4:6, 4:6, 4:6] = True
    return {
        "random3d": rng.random((12, 13, 11)) > 0.7,
        "spiral": spiral,
        "tie": tie,
        "random2d": rng.random((20, 18)) > 0.6,
        "empty": np.zeros((5, 6, 7), bool),
    }


def test_connected_components_labels_match_jax(rng):
    """Same algorithm, same numbering: 1 + flat index of each island's
    minimal voxel."""
    for name, mask in _masks(rng).items():
        want = np.asarray(jcc.connected_components(jnp.asarray(mask)))
        got = tcc.connected_components(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            tcc.component_sizes(torch.from_numpy(got)).numpy(),
            np.asarray(jcc.component_sizes(jnp.asarray(want))), err_msg=name)


@pytest.mark.parametrize("impl", ["device", "native", "auto"])
def test_largest_component_matches_jax(rng, impl):
    for name, mask in _masks(rng).items():
        want = np.asarray(jcc.largest_component(jnp.asarray(mask), impl=impl))
        got = tcc.largest_component(torch.from_numpy(mask), impl=impl)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {impl}")


@pytest.mark.parametrize("impl", ["device", "native"])
def test_filter_similarity_largest_island_matches_jax(rng, impl):
    sim = rng.integers(0, 256, (14, 12, 10)).astype(np.uint8)
    sim[2:6, 2:6, 2:6] = 200  # one dominant island
    for thr in (69, 180):
        want = np.asarray(jcc.filter_similarity_largest_island(jnp.asarray(sim), thr, impl=impl))
        got = tcc.filter_similarity_largest_island(torch.from_numpy(sim), thr, impl=impl)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_native_label_matches_jax_native(rng):
    from vittf_tpu.native import cc3d_label

    mask = rng.random((10, 9, 8)) > 0.6
    want, n_want = cc3d_label(mask)
    got, n_got = native.cc3d_label(mask)
    assert n_got == n_want > 1
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="3D mask"):
        native.cc3d_label(mask[0])


def test_native_builds_under_build_dir():
    so = native.library_path()
    assert so.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "vittf_tpu_torch"
    native.get_lib()
    assert so.exists()


def test_native_build_raises_without_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.cc3d_largest(np.ones((2, 2, 2), bool))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tcc.largest_component(torch.ones((2, 2, 2), dtype=torch.bool), impl="native")
