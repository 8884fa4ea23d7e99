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
        "        'core.rle', 'core.config', 'utils.polygon', 'utils.timer', 'pipeline.reporting',\n"
        "        'pipeline.visualize', 'models.serialization', 'core.synthetic', 'cli.synth',\n"
        "        'cli.convert_weights', 'models.cnn3d', 'train.utils', 'train.losses',\n"
        "        'train.gather', 'train.moco', 'train.probe'}\n"
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
VERBATIM = ["core/rle.py", "core/config.py", "utils/polygon.py", "utils/timer.py",
            "utils/flops.py", "pipeline/reporting.py", "pipeline/visualize.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    import re

    want = re.sub(r"vittf_tpu\b", "vittf_tpu_torch", (REPO / "vittf_tpu" / rel).read_text())
    if rel == "core/rle.py":
        want = want.replace("``/" + "root/reference/old/", "``old/")
    assert (REPO / "vittf_tpu_torch" / rel).read_text() == want


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


def test_infer_requires_cuda_without_cpu_flag(tmp_path, monkeypatch):
    """No CUDA device: the port's CLI raises unless ``--cpu`` is given; with
    it, ``--streamed`` writes the JAX CLI's ``--streamed`` artifact (uint16
    volume, streamed compact; vits8, fos 4, parity mode) and
    ``--data-parallel`` is refused."""
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
    with pytest.raises(NotImplementedError, match="data-parallel"):
        infer.main(["--data-path", str(tmp_path / "v.npy"), "--cpu", "--data-parallel"])


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
