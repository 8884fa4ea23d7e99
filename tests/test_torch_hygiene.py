"""Port hygiene: vittf_tpu_torch never imports JAX, and nothing falls back
to the CPU where a GPU was asked for."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, env_extra=None, cwd=REPO):
    env = {**os.environ, **(env_extra or {})}
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vittf_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vittf_tpu_torch.__path__, 'vittf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) >= 50, names\n"
        "need = {'pipeline.session', 'cli.serve', 'ops.chain_gemm', 'scripts.bench_int8_gemm',\n"
        "        'convert.volumes', 'cli.convert', 'cli.batch', 'cli.evaluate', 'cli.predict_svm_rf',\n"
        "        'pipeline.baselines', 'pipeline.compare_sampling', 'pipeline.merge', 'pipeline.tiling',\n"
        "        'ops.query', 'ops.bilateral_sparse', 'models.clip', 'utils.logging', 'utils.flops',\n"
        "        'core.rle', 'core.config', 'utils.polygon', 'pipeline.reporting',\n"
        "        'pipeline.visualize', 'models.serialization', 'core.synthetic', 'cli.synth',\n"
        "        'cli.convert_weights', 'models.cnn3d', 'train.utils', 'train.losses',\n"
        "        'train.gather', 'train.moco', 'train.probe', 'train.optim', 'train.contrastive',\n"
        "        'train.dense', 'train.intra_clr', 'train.paws', 'cli.train', 'cli.sweep', '_lazy',\n"
        "        'train.vit_ssl', 'pipeline.quality', 'parallel', 'parallel.mesh', 'parallel.extract',\n"
        "        'parallel.pipeline_parallel'}\n"
        "assert {'vittf_tpu_torch.' + n for n in need} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'vittf_tpu.')) or m == 'vittf_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


# the jax-free host modules the port keeps as copies: the same text but for
# the package name (and, in rle.py, a machine path in the docstring, which the
# copy gives relative to the reference's tree)
VERBATIM = ["core/rle.py", "core/config.py", "utils/polygon.py", "utils/flops.py",
            "pipeline/reporting.py", "pipeline/visualize.py"]
# the lines a copy changes, and no others: utils/flops.py counts the SwiGLU FFN
# and the register tokens of the port's DINOv2 ViT-g/14, which the JAX
# package's ViT does not have
CHANGED_LINES = {"utils/flops.py": [
    "+     A SwiGLU FFN (the port's DINOv2 ViT-g/14) counts 6·N·D·H for its w12",
    "+     (2H wide) and w3; N counts CLS and the register tokens, which the patch",
    "+     embed does not see.",
    '-     mlp_mult = getattr(cfg, "mlp_ratio", 4.0)',
    "-     full_block = (8 + 4 * mlp_mult) * N * D * D + 4 * N * N * D",
    '+     ffn = (6 if cfg.ffn == "swiglu" else 4) * N * D * cfg.hidden_dim',
    "+     full_block = 8 * N * D * D + ffn + 4 * N * N * D",
    "-     embed = 2 * (N - 1) * D * (embed_in_ch * p * p)",
    "+     embed = 2 * (N - cfg.prefix_tokens) * D * (embed_in_ch * p * p)",
    "-         n_tokens = f_h * f_w + 1",
    "+         n_tokens = f_h * f_w + cfg.prefix_tokens",
]}


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    import difflib
    import re

    want = re.sub(r"vittf_tpu\b", "vittf_tpu_torch", (REPO / "vittf_tpu" / rel).read_text())
    if rel == "core/rle.py":
        want = want.replace("``/" + "root/reference/old/", "``old/")
    got = (REPO / "vittf_tpu_torch" / rel).read_text()
    if rel not in CHANGED_LINES:
        assert got == want
        return
    diff = [d for d in difflib.ndiff(want.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert diff == CHANGED_LINES[rel]


def test_sweep_cli_is_a_near_verbatim_copy():
    """``cli/sweep.py`` is the JAX file but for the package name and the
    ``--cpu`` flag it adds and hands to the trainer factory."""
    import difflib
    import re

    want = re.sub(r"vittf_tpu\b", "vittf_tpu_torch", (REPO / "vittf_tpu/cli/sweep.py").read_text())
    got = (REPO / "vittf_tpu_torch/cli/sweep.py").read_text()
    diff = [d for d in difflib.ndiff(want.splitlines(), got.splitlines()) if d[:2] in ("- ", "+ ")]
    assert diff == [
        '+     p.add_argument("--cpu", action="store_true", help="Run on the CPU")',
        "+             cpu=args.cpu,",
    ]


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test that runs a full-width model on the
    CPU: beside other test workers, torch's default threads oversubscribe
    the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_infer_requires_cuda_without_cpu_flag(tmp_path, monkeypatch, one_torch_thread):
    """No CUDA device: the port's CLI raises unless ``--cpu`` is given; with
    it, ``--streamed`` writes the JAX CLI's ``--streamed`` artifact (uint16
    volume, streamed compact; vits8, fos 4, parity mode)."""
    import numpy as np
    import torch

    from vittf_tpu.cli import infer as jax_infer
    from vittf_tpu_torch.cli import infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "v.npy", np.zeros((8, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--data-path", str(tmp_path / "v.npy")])
    vol = np.random.default_rng(0).integers(0, 4000, (16, 16, 16), dtype=np.uint16)
    np.save(tmp_path / "u.npy", vol)
    args = ["--data-path", str(tmp_path / "u.npy"), "--feature-output-size", "4",
            "--precision", "highest", "--streamed", "--chunk-batches", "2"]
    assert jax_infer.main(args + ["--cache-path", str(tmp_path / "jax.npy")]) == 0
    assert infer.main(args + ["--cpu", "--cache-path", str(tmp_path / "port.npy")]) == 0
    want = np.load(tmp_path / "jax.npy", allow_pickle=True)[()]["k"]
    got = np.load(tmp_path / "port.npy", allow_pickle=True)[()]["k"]
    assert got.dtype == np.float16 and got.shape == want.shape == (384, 4, 4, 4)
    # fp16 artifacts: fp32 sums that differ in the last bits may round apart
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=1e-3, atol=1e-5)


def test_infer_data_parallel_on_one_rank_is_the_plain_path(tmp_path, monkeypatch,
                                                            one_torch_thread):
    """The JAX CLI's dispatch: ``--data-parallel`` with one rank (no process
    group here) writes the port's plain artifact bit for bit, and the JAX
    CLI's ``--data-parallel`` artifact (its sharded path over the 8 virtual
    CPU devices) within 1e-5 (fp32 artifacts, parity mode; twelve ViT-S/8
    blocks put a few values 1.8e-6 apart, where the golden features' tiny
    model holds 1e-6). More than one rank takes the sharded path:
    ``tests/test_torch_parallel.py::test_infer_data_parallel_over_ranks``."""
    import numpy as np

    from vittf_tpu.cli import infer as jax_infer
    from vittf_tpu_torch.cli import infer

    np.save(tmp_path / "v.npy", np.random.default_rng(1).random((16, 16, 16), dtype=np.float32))
    args = ["--data-path", str(tmp_path / "v.npy"), "--feature-output-size", "4",
            "--precision", "highest", "--feature-dtype", "float32"]
    out = {}
    for name, extra in (("plain", ["--cpu"]), ("dp", ["--cpu", "--data-parallel"])):
        assert infer.main(args + extra + ["--cache-path", str(tmp_path / f"{name}.npy")]) == 0
        out[name] = np.load(tmp_path / f"{name}.npy", allow_pickle=True)[()]["k"]
    assert jax_infer.main(args + ["--data-parallel", "--cache-path", str(tmp_path / "jax.npy")]) == 0
    want = np.load(tmp_path / "jax.npy", allow_pickle=True)[()]["k"]
    assert out["dp"].dtype == np.float32 and out["dp"].shape == want.shape == (384, 4, 4, 4)
    np.testing.assert_array_equal(out["dp"], out["plain"])
    np.testing.assert_allclose(out["dp"], want, rtol=1e-5, atol=1e-5)


def test_serve_requires_cuda_without_cpu_flag(tmp_path, monkeypatch):
    """No CUDA device and no ``--cpu``: ``serve`` raises before it serves
    anything, and never runs on the CPU silently; the session does the same
    for ``device=None``."""
    import numpy as np
    import torch

    from vittf_tpu_torch.cli import serve
    from vittf_tpu_torch.pipeline.session import InteractiveSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "volume.npy", rng.random((8, 8, 8)).astype(np.float32))
    np.save(tmp_path / "x_features4.npy",
            np.asarray({"k": rng.standard_normal((4, 4, 4, 4)).astype(np.float16)}, dtype=object))
    np.save(tmp_path / "annotations.npy", {"a": rng.integers(0, 8, (3, 3))}, allow_pickle=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--data", str(tmp_path), "--max-updates", "1"])
    assert not (tmp_path / "similarities.npy").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractiveSession.from_artifacts(tmp_path)
    assert serve.main(["--data", str(tmp_path), "--max-updates", "1", "--cpu", "--no-prewarm",
                       "--poll-interval", "0.05"]) == 0
    assert (tmp_path / "similarities.npy").exists()


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    from vittf_tpu_torch import kernels

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_library()


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    from vittf_tpu_torch import kernels

    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path()
    assert first.parent == kernels.BUILD_DIR and first.suffix == ".so"
    (tmp_path / "b.cu").write_text("// edited\n")
    assert kernels.library_path() != first


@pytest.mark.parametrize("edit", ["add", "change"])
def test_library_name_tracks_headers(tmp_path, monkeypatch, edit):
    """A header shared by the sources (``*.cuh``) is part of the library's
    name: editing it can never load a library built from the old text."""
    from vittf_tpu_torch import kernels

    (tmp_path / "a.cu").write_text('#include "core.cuh"\n')
    if edit == "change":
        (tmp_path / "core.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path()
    (tmp_path / "core.cuh").write_text("// v2\n")
    assert kernels.library_path() != first


def test_shipped_headers_are_hashed():
    from vittf_tpu_torch import kernels

    names = {p.name for p in kernels._sources()}
    assert {"attention.cu", "attention_core.cuh", "async_copy.cuh", "splat_ordered.cuh"} <= names


# public functions whose ``device`` default is the CPU by design: converters
# of the JAX package's trees into host tensors
CPU_DEFAULT_CONVERTERS = {"vittf_tpu_torch.models.cnn3d.params_from_jax"}


def test_no_public_device_parameter_defaults_to_the_cpu():
    """Every public function, method and class of the port takes the card
    when no device is given (``utils.tensor.resolve_device``: the first CUDA
    device or a RuntimeError); none defaults ``device`` to the CPU but the
    named converters."""
    import importlib
    import inspect
    import pkgutil

    import torch

    import vittf_tpu_torch

    found, cpu_default = 0, []
    for info in pkgutil.walk_packages(vittf_tpu_torch.__path__, "vittf_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [(f"{name}.{m}", f) for m, f in vars(obj).items()
                       if (not m.startswith("_") or m == "__init__") and inspect.isfunction(f)]
            for qual, fn in fns:
                param = inspect.signature(fn).parameters.get("device")
                if param is None:
                    continue
                found += 1
                d = param.default
                if (d == "cpu" or (isinstance(d, torch.device) and d.type == "cpu")) and \
                        f"{mod.__name__}.{qual}" not in CPU_DEFAULT_CONVERTERS:
                    cpu_default.append(f"{mod.__name__}.{qual}")
    assert found >= 30, found
    assert not cpu_default, cpu_default


@pytest.mark.parametrize("entry", ["extract_features", "extract_features_streamed",
                                   "annotations_from_labels"])
def test_entry_points_take_the_card_or_raise(entry, monkeypatch):
    """With no device given, the three entry points that used to default to
    the CPU raise when no CUDA device is visible, and never run there."""
    import numpy as np
    import torch

    from tests.test_torch_vit import port_cfg
    from tests.test_vit import TINY
    from vittf_tpu_torch.models.vit import init_vit_params
    from vittf_tpu_torch.pipeline.annotations import annotations_from_labels
    from vittf_tpu_torch.pipeline.features import ExtractConfig, extract_features
    from vittf_tpu_torch.pipeline.streamed import extract_features_streamed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 8, 8), np.float32)
    sd = init_vit_params(port_cfg(TINY))
    call = {
        "extract_features": lambda: extract_features(vol, sd, port_cfg(TINY), ExtractConfig()),
        "extract_features_streamed": lambda: extract_features_streamed(vol, sd, port_cfg(TINY)),
        "annotations_from_labels": lambda: annotations_from_labels(vol.astype(np.uint8) + 1, 4),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
