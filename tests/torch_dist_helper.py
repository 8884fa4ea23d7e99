"""Run cases of the port's multi-device layer on several gloo ranks of the CPU.

    python tests/torch_dist_helper.py WORLD PORT WORKDIR [--env-init]

``WORKDIR/inputs.pt`` maps a case name (a ``case_*`` function below) to its
inputs; ``WORLD`` ranks are spawned by ``torch.multiprocessing``, join a gloo
group at ``tcp://127.0.0.1:PORT`` (``init_process_group`` timeout 60 s; with
``--env-init`` they get torchrun's environment variables instead, and the
case joins the group itself), run every case and write their outputs to
``WORKDIR/rank<r>.pt``. The tests call ``run_ranks``, which starts this
script in a process group of its own and kills it at a deadline. This module
imports only the standard library, torch and the port: no rank imports JAX.
"""
from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, inputs: dict, workdir: Path, env_init: bool = False,
              deadline: float = 240.0) -> list[dict]:
    """Every case of ``inputs`` on ``world`` gloo ranks; returns each rank's
    outputs. Fails (``AssertionError``) when a rank fails, or when the ranks
    have not finished by ``deadline`` seconds (they are killed then)."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    cmd = [sys.executable, str(HERE), str(world), str(free_port()), str(workdir)]
    proc = subprocess.Popen(cmd + (["--env-init"] if env_init else []), cwd=HERE.parents[1],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{world} ranks did not finish in {deadline} s:\n{out[-4000:]}")
    assert proc.returncode == 0, f"ranks failed (rc {proc.returncode}):\n{out[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------- the cases (run on every rank) ----------------

def _mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size}, as a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def case_mesh(inp, rank, world):
    from vittf_tpu_torch.parallel.mesh import make_mesh

    out = {"data": _mesh_shape(make_mesh(data=world)), "default": _mesh_shape(make_mesh()),
           "model": _mesh_shape(make_mesh(data=1, model=world))}
    try:
        make_mesh(data=2 * world, model=2)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def case_extract(inp, rank, world):
    from vittf_tpu_torch.models.vit import ViTConfig
    from vittf_tpu_torch.parallel.extract import extract_features_sharded
    from vittf_tpu_torch.parallel.mesh import make_mesh
    from vittf_tpu_torch.pipeline.features import ExtractConfig

    mesh = make_mesh(data=world)
    cfg = ViTConfig(**inp["vit"])
    return {name: extract_features_sharded(vol, inp["params"], cfg, ExtractConfig(**kw), mesh,
                                           device="cpu")["k"]
            for name, (vol, kw) in inp["cases"].items()}


def case_similarity(inp, rank, world):
    from vittf_tpu_torch.parallel.extract import similarity_sharded
    from vittf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=world)
    return {name: similarity_sharded(f, q, m, mesh, **kw)
            for name, (f, q, m, kw) in inp.items()}


def case_tp(inp, rank, world):
    from vittf_tpu_torch.models.vit import ViTConfig
    from vittf_tpu_torch.parallel.mesh import make_mesh, shard_params, tp_vit_forward

    mesh = make_mesh(data=1, model=world)
    local = shard_params(inp["params"], mesh)
    tok, qkv = tp_vit_forward(local, inp["images"], ViTConfig(**inp["vit"]), mesh,
                              precision="highest", attn_impl="plain")
    return {"tokens": tok, "qkv": qkv, "qkv_rows": local["blocks.0.attn.qkv.weight"].shape[0]}


def case_pp(inp, rank, world):
    from torch.distributed.device_mesh import DeviceMesh

    from vittf_tpu_torch.models.vit import ViTConfig
    from vittf_tpu_torch.parallel.pipeline_parallel import pp_vit_forward

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("pipe",))
    out = {}
    for name, (params, vit, images, n_micro) in inp.items():
        out[name] = pp_vit_forward(params, images, ViTConfig(**vit), mesh, n_micro=n_micro,
                                   precision="highest", attn_impl="plain")
    try:
        params, vit, images, _ = next(iter(inp.values()))
        pp_vit_forward(params, images[:3], ViTConfig(**vit), mesh, n_micro=2)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def case_cli(inp, rank, world):
    """The infer CLI with ``--data-parallel``, joining the group itself from
    torchrun's environment (run with ``--env-init``)."""
    from vittf_tpu_torch.cli import infer

    assert not torch.distributed.is_initialized()
    rc = infer.main(inp["args"])
    return {"rc": rc, "world": torch.distributed.get_world_size(),
            "backend": torch.distributed.get_backend()}


def _rank_main(rank: int, world: int, port: int, workdir: str, env_init: bool) -> None:
    torch.set_num_threads(1)
    if env_init:
        os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    else:
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    out = {name: globals()[f"case_{name}"](inp, rank, world) for name, inp in inputs.items()}
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    sys.path.insert(0, str(HERE.parents[1]))  # the port, from the repo's root

    world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp.start_processes(_rank_main, args=(world, port, workdir, "--env-init" in sys.argv),
                       nprocs=world, start_method="spawn", join=True)
