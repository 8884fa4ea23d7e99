"""The port's public surface: every name a vittf_tpu ``__init__.py`` imports
resolves from the same package of vittf_tpu_torch (its ``__init__`` files
resolve them lazily), but for the decided exceptions below; and the twins
of the three public functions the port lacked (``make_3d``,
``norm_mean_std``, ``grid_sample_3d``) against the JAX package.
"""
import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

# name → why the port's package does not export it
EXCEPTIONS = {
    "convert_torch_state_dict": "no twin: the port keeps the hub layout (models.dino "
                                "params_from_jax / params_to_jax convert)",
    "vit_forward": "a method of the port's VisionTransformer",
    "vit_forward_raw": "a method of the port's VisionTransformer",
    "Timer": "no twin: the port's stage timer timed the enqueue and had no reader; its "
             "profiler spans are utils.logging.span",
    "StageTimings": "no twin: as Timer",
}
PACKAGES = sorted(str(p.parent.relative_to(REPO / "vittf_tpu")).replace("/", ".")
                  for p in (REPO / "vittf_tpu").rglob("__init__.py"))


def jax_init_names(package: str) -> list[str]:
    """The names ``vittf_tpu[.package]/__init__.py`` imports (read from its
    text, so that nothing of JAX is imported for it)."""
    sub = "" if package == "." else package.replace(".", "/")
    path = REPO / "vittf_tpu" / sub / "__init__.py"
    return [a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) and node.module.startswith("vittf_tpu")
            for a in node.names]


@pytest.mark.parametrize("package", PACKAGES)
def test_port_init_resolves_the_jax_names(package):
    names = jax_init_names(package)
    port = importlib.import_module("vittf_tpu_torch" + ("" if package == "." else "." + package))
    missing = [n for n in names if n not in EXCEPTIONS and not hasattr(port, n)]
    assert not missing, missing
    exported = set(getattr(port, "__all__", ()))
    assert {n for n in names if n not in EXCEPTIONS} <= exported
    for name in exported:  # each export is the port's twin, not a JAX object
        obj = getattr(port, name)
        assert not callable(obj) or obj.__module__.startswith("vittf_tpu_torch."), name


def test_exceptions_are_all_still_jax_names():
    """An exception names a JAX export the port does not resolve; drop it
    from the list when the port gains the name."""
    jax_names = {n for p in PACKAGES for n in jax_init_names(p)}
    assert set(EXCEPTIONS) <= jax_names
    import vittf_tpu_torch.models as models

    for name in ("convert_torch_state_dict", "vit_forward"):
        assert not hasattr(models, name)


# the modules of the last slice: each public name of the JAX module (read
# from its text) is the port module's
SLICE_MODULES = ["train/vit_ssl.py", "pipeline/quality.py", "parallel/mesh.py",
                 "parallel/extract.py", "parallel/pipeline_parallel.py"]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_port_module_has_the_jax_modules_public_names(rel):
    tree = ast.parse((REPO / "vittf_tpu" / rel).read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name) and t.id.isupper()]
    assert names
    port = importlib.import_module("vittf_tpu_torch." + rel[:-3].replace("/", "."))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for n in names:
        obj = getattr(port, n)
        assert not callable(obj) or obj.__module__.startswith("vittf_tpu_torch."), n


def test_train_and_pipeline_export_the_jax_names():
    """``vittf_tpu_torch.{train,pipeline,parallel}`` resolve every name their
    JAX packages export, with the slice's modules in place."""
    for package in ("train", "pipeline", "parallel"):
        port = importlib.import_module(f"vittf_tpu_torch.{package}")
        for name in jax_init_names(package):
            assert getattr(port, name).__module__.startswith("vittf_tpu_torch."), name


def test_make_3d_and_norm_mean_std_match_jax(rng):
    from vittf_tpu.utils import tensor as jt
    from vittf_tpu_torch.utils import tensor as tt

    for shape in ((5,), (4, 5), (2, 4, 5)):
        x = rng.standard_normal(shape).astype(np.float32)
        assert tuple(tt.make_3d(torch.from_numpy(x)).shape) == jt.make_3d(jnp.asarray(x)).shape
    with pytest.raises(ValueError, match="cannot reduce"):
        tt.make_3d(torch.zeros((1, 2, 3, 4)))
    x = (rng.random((6, 7, 8)) * 3000).astype(np.uint16)
    for mu, std in ((0.0, 1.0), (0.5, 2.0)):
        got = tt.norm_mean_std(torch.from_numpy(x.astype(np.int32)), mu, std)
        want = np.asarray(jt.norm_mean_std(jnp.asarray(x.astype(np.int32)), mu, std))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the sample std (ddof 1): the standardized volume has unit sample std
    assert float(tt.norm_mean_std(torch.from_numpy(x).float()).std(correction=1)) == \
        pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_matches_jax(rng, mode, align_corners):
    from vittf_tpu.ops.sampling import grid_sample_3d as jgs
    from vittf_tpu_torch.ops import grid_sample_3d

    inp = rng.standard_normal((2, 4, 5, 6, 7)).astype(np.float32)
    # out-of-range points exercise the zero padding
    grid = (rng.random((2, 3, 4, 2, 3)).astype(np.float32) * 2.6) - 1.3
    want = np.asarray(jgs(jnp.asarray(inp), jnp.asarray(grid), mode=mode,
                          align_corners=align_corners))
    got = grid_sample_3d(torch.from_numpy(inp), torch.from_numpy(grid), mode=mode,
                         align_corners=align_corners)
    assert got.shape == want.shape == (2, 4, 3, 4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
