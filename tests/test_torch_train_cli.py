"""Port parity: vittf_tpu_torch.cli.{train,sweep} against the vittf_tpu
CLIs, on the CPU (``--cpu``), on one small ``.npy`` data dict: for every
trainer the same JSONL keys and steps, checkpoints at the same steps,
``--resume`` going on from the saved step, finite losses; the sweep's
summary; and no silent CPU run without ``--cpu``.
"""
import json

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_train_contrastive import one_torch_thread  # noqa: F401 (autouse)
from vittf_tpu.cli import sweep as jax_sweep
from vittf_tpu.cli import train as jax_train
from vittf_tpu_torch.cli import sweep, train
from vittf_tpu_torch.models.serialization import checkpoint_steps, restore_checkpoint
from vittf_tpu_torch.train.optim import tree_leaves


@pytest.fixture
def npy_data(tmp_path, rng):
    mask = np.zeros((12, 12, 12), np.int32)
    mask[2:6, 2:6, 2:6] = 1
    mask[7:11, 7:11, 7:11] = 2
    vol = ((mask == 1) * 0.8 + (mask == 2) * 0.2 + rng.random(mask.shape) * 0.05)
    path = tmp_path / "data.npy"
    np.save(path, {"vol": vol.astype(np.float32), "mask": mask,
                   "labels": ["background", "a", "b"]}, allow_pickle=True)
    return path


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _orbax_steps(ckpt):
    return sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())


@pytest.mark.parametrize("trainer", ["semisparse", "dense", "paws", "intra_clr"])
def test_train_cli_matches_jax_cli(tmp_path, npy_data, trainer):
    common = ["--trainer", trainer, "--data", str(npy_data), "--batch-size", "4",
              "--ckpt-every", "2", "--log-every", "0"]
    runs = {"jax": (jax_train.main, []), "port": (train.main, ["--cpu"])}
    for name, (main, extra) in runs.items():
        ckpt, log = tmp_path / f"{name}_ckpt", tmp_path / f"{name}.jsonl"
        assert main(common + extra + ["--iterations", "4", "--ckpt-dir", str(ckpt),
                                      "--log-jsonl", str(log)]) == 0
        assert main(common + extra + ["--iterations", "6", "--ckpt-dir", str(ckpt),
                                      "--log-jsonl", str(log), "--resume"]) == 0
    want, got = _log(tmp_path / "jax.jsonl"), _log(tmp_path / "port.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4, 5, 6]
    assert [r.keys() for r in got] == [r.keys() for r in want]
    assert all(np.isfinite(v) for r in got for k, v in r.items() if k not in ("step", "time"))
    assert checkpoint_steps(tmp_path / "port_ckpt") == _orbax_steps(tmp_path / "jax_ckpt") \
        == [2, 4, 6]
    state = restore_checkpoint(tmp_path / "port_ckpt")
    assert state["step"] == 6 and isinstance(state["params"], dict)


def test_train_cli_resume_restores_params_and_step(tmp_path, npy_data, capsys):
    """``--resume`` loads the saved parameters into the trainer (in place)
    and goes on from the saved step; at the saved step it trains no more
    and saves the same parameters again."""
    args = ["--trainer", "semisparse", "--data", str(npy_data), "--batch-size", "4",
            "--cpu", "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "0"]
    assert train.main(args + ["--iterations", "3"]) == 0
    saved = restore_checkpoint(tmp_path / "ck", 3)
    assert train.main(args + ["--iterations", "3", "--resume"]) == 0
    assert "Resumed from step 3" in capsys.readouterr().out
    again = restore_checkpoint(tmp_path / "ck", 3)
    for a, b in zip(tree_leaves(saved["params"]), tree_leaves(again["params"])):
        assert torch.equal(a, b)


def test_sweep_cli_matches_jax(tmp_path, npy_data):
    cfg = {"trainer": "semisparse", "metric": "infonce", "goal": "minimize",
           "grid": {"learning_rate": [0.001, 0.003]}, "fixed": {"iterations": 3, "batch_size": 4}}
    (tmp_path / "sweep.yaml").write_text(yaml.safe_dump(cfg))
    base = ["--config", str(tmp_path / "sweep.yaml"), "--data", str(npy_data)]
    assert jax_sweep.main(base + ["--out", str(tmp_path / "jax")]) == 0
    assert sweep.main(base + ["--out", str(tmp_path / "port"), "--cpu"]) == 0
    want = json.loads((tmp_path / "jax" / "sweep.json").read_text())
    got = json.loads((tmp_path / "port" / "sweep.json").read_text())
    assert got.keys() == want.keys() == {"metric", "best", "runs"}
    assert [r["point"] for r in got["runs"]] == [r["point"] for r in want["runs"]]
    assert [r["final"].keys() for r in got["runs"]] == [r["final"].keys() for r in want["runs"]]
    assert all(np.isfinite(r["score"]) for r in got["runs"])
    grid = {"a": [1, 2], "b": [3]}
    assert sweep.expand_grid(grid) == jax_sweep.expand_grid(grid)


def test_train_cli_requires_cuda_without_cpu_flag(tmp_path, npy_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--trainer", "paws", "--data", str(npy_data), "--iterations", "1"])
    pt = tmp_path / "data.pt"  # the .pt contract loads as the JAX CLI's does
    d = np.load(npy_data, allow_pickle=True)[()]
    torch.save({"vol": torch.from_numpy(d["vol"]), "mask": torch.from_numpy(d["mask"]),
                "labels": d["labels"]}, pt)
    for a, b in zip(train.load_train_data(pt), jax_train.load_train_data(pt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.save(tmp_path / "bare.npy", np.zeros(3))
    with pytest.raises(SystemExit, match="bare array"):
        train.load_train_data(tmp_path / "bare.npy")
