"""Parameter (de)serialization: flat-npz interchange and training checkpoints.

Port of ``vittf_tpu/models/serialization.py``.

- ``save_params_npz`` / ``load_params_npz``: the dependency-free flat-key
  format (``blocks.3.qkv.kernel`` → array) of the JAX package, byte for byte:
  a file written by either package loads in the other. The tree is what the
  writer gave (for the ViT, the JAX layout: ``models.dino.params_to_jax`` /
  ``params_from_jax`` convert it to and from the port's ``state_dict``).
- ``save_checkpoint`` / ``restore_checkpoint``: training state (params,
  optimizer state, step) as one ``torch.save`` file a step,
  ``<dir>/step_<n>.pt``. The JAX package writes orbax directories instead;
  neither reads the other's checkpoints.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch


def flatten_params(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists of tensors or arrays → {dotted key: ndarray}."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}."))
    elif torch.is_tensor(params):
        out[prefix[:-1]] = params.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: dict[str, np.ndarray]):
    """Inverse of ``flatten_params``: CPU tensors; a level whose keys are all
    digits becomes a list."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(val))

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params_npz(path: str | Path, params) -> Path:
    path = Path(path)
    np.savez(path, **flatten_params(params))
    return path


def load_params_npz(path: str | Path):
    with np.load(path) as flat:
        return unflatten_params({k: flat[k] for k in flat.files})


def _step_path(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step}.pt"


def save_checkpoint(ckpt_dir: str | Path, state, step: int) -> Path:
    """``state`` (params, optimizer ``state_dict``s, …: anything
    ``torch.save`` takes) as ``ckpt_dir/step_<step>.pt``; returns the dir."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = _step_path(ckpt_dir, step).with_suffix(".tmp")
    torch.save(state, tmp)
    tmp.replace(_step_path(ckpt_dir, step))
    return ckpt_dir


def checkpoint_steps(ckpt_dir: str | Path) -> list[int]:
    """The steps saved under ``ckpt_dir``, ascending."""
    names = (re.fullmatch(r"step_(\d+)\.pt", p.name) for p in Path(ckpt_dir).glob("step_*.pt"))
    return sorted(int(m.group(1)) for m in names if m)


def restore_checkpoint(ckpt_dir: str | Path, step: int | None = None, map_location="cpu"):
    """The state saved at ``step`` (the latest when None), tensors on
    ``map_location``. Raises ``FileNotFoundError`` when there is none."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        step = steps[-1]
    return torch.load(_step_path(ckpt_dir, step), map_location=map_location, weights_only=False)
