"""The bilateral kernels (K4-K8) and their library yardsticks timed five ways
on the card, at the shapes of ``chip_smoke.py``'s bilateral phases: five
128³ classes at the refinement's grid (σ_s 7, σ_l 5) and one 2048² image at
the 2-D solver's (σ_s 24, σ_l 4). The blur (K8) is also timed at the lattice
of the whole-grid refinement (``bls_blur_wholegrid``: a 256³ grid, as many
classes as one chunk of ``pipeline/refine.py`` holds, 42 MB) and of the 2-D
solver (``bls_blur_2d``). K8's, K6a's and K6b's yardstick is a copy floor
(``copy_*``): ``out.copy_(src)`` of as many bytes as the kernel reads and
writes, the least any pass over them can take; it is not a library call for
the kernel's function (none exists).

    python3 -m vittf_tpu_torch.scripts.bilateral_timing [--only bls_slice,bls_blur]
    python3 vittf_tpu_torch/scripts/bilateral_timing.py --root DIR   # another checkout's kernels
    python3 vittf_tpu_torch/scripts/bilateral_timing.py --root DIR \
        --only bls_blur,bls_blur_wholegrid,bls_blur_2d,bls_reblock,bls_unreblock

The readings, each taken twice in turns (kernel, yardstick, yardstick,
kernel), with the timers of ``utils/cuda_timing.py``:

(a) one call between two CUDA events, median of 7: the host's launch path
    of the call lies between the events;
(b) ten calls between two events, median of 7, / 10 (``ten_call_ms``);
(c) the device time of the call's kernels in a ``torch.profiler`` trace of
    20 calls, per call, with the kernels' names;
(d) the host's time per call: 100 calls enqueued without a synchronise,
    twenty times over, the median of the twenty / 100;
(e) as (b), with a 128 MB buffer read before each call (the L2 cold) and
    each call between its own events.

Each line also carries ``bound_ms``: the kernel's bytes (each input read
once, each output written once) over 3.35 TB/s, the same on its yardstick's
line.

(b), (c) and (e) are device time; (a) - (b) is what the host adds to a
one-call reading, and (d) is the wrapper's whole host path. ``--root`` times
the kernels and wrappers of another checkout of the repository (the parent
commit unpacked beside this one): run the script by its path then, not with
``-m``. Registers and spills: ``chip_smoke.py --ptxas``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
SS, SL, C, SIZE = 7, 5, 5, 128  # the refinement's grid, five classes of 128³
SS2D, SL2D, SIZE2D = 24, 4, 2048  # the 2-D solver's default grid
WG_SIZE = 256  # chip_smoke.py's whole-grid refinement: 256³, support everywhere
# classes a chunk of pipeline/refine.py holds at its VITTF_BLS_CHUNK_VOXELS default
WG_CLASSES = 70_000_000 // WG_SIZE**3
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet


def profiled_ms(fn, calls: int = 20, tries: int = 3) -> tuple[float, list[str]]:
    """Device time per call of the kernels ``fn`` launches, from a
    torch.profiler trace, and their names. A trace that comes back without
    device events (the profiler drops them now and then) is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.end - e.time_range.start
        if per:
            return sum(per.values()) / calls / 1e3, sorted(n[:60] for n in per)
    raise RuntimeError(f"{tries} traces held no device time")


def host_us(fn, calls: int = 2000, batch: int = 100) -> float:
    """Host time per call in µs: the median over batches of ``batch`` calls
    enqueued without a synchronise (few enough that the launch queue never
    fills); the median leaves out batches that the host's scheduler stalled."""
    fn()
    torch.cuda.synchronize()
    per_batch = []
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        per_batch.append((time.perf_counter() - t0) / batch * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_batch)


def readings(fn, timing) -> dict:
    prof_ms, names = profiled_ms(fn)
    return {"one_call_ms": timing.one_call_ms(fn), "ten_call_ms": timing.ten_call_ms(fn),
            "profiler_ms": prof_ms, "host_us": host_us(fn),
            "ten_call_cold_l2_ms": timing.ten_call_ms(fn, cold_l2=True), "kernels": names}


def load_timing():
    """This checkout's ``utils/cuda_timing.py``, loaded by its path: with
    ``--root`` the package on ``sys.path`` is the other checkout's, which
    may not hold it."""
    spec = importlib.util.spec_from_file_location(
        "cuda_timing", HERE / "vittf_tpu_torch" / "utils" / "cuda_timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases(bl, copy_floor) -> list[tuple[str, str | None, object, object, int]]:
    """(kernel name, yardstick name, kernel call, yardstick call, bytes the
    kernel must move) at the phases' shapes, inputs made beforehand;
    ``copy_floor`` makes the copies timed beside K8, K6a and K6b."""
    gen = torch.Generator().manual_seed(0)
    shape = (SIZE,) * 3
    luma = torch.randint(0, 256, (C,) + shape, generator=gen).float().cuda()
    t, c = (torch.rand((C,) + shape, generator=gen).cuda() for _ in range(2))
    ext = bl._grid_extents(shape, SS, SL)
    L, nverts = ext[-1], math.prod(ext)
    n_cells = nverts // L
    lat = torch.randn((C,) + ext, generator=gen).cuda()
    yl = lat.reshape(C, -1, L)
    tc = t * c
    vid = bl._vertex_ids(shape, luma, SS, SL)[0]
    offs = torch.arange(C, device="cuda").reshape(C, 1, 1, 1) * nverts
    flat_ids = (vid + offs).reshape(-1)
    src = torch.stack([torch.ones_like(c), c, tc], dim=-1).reshape(-1, 3)
    acc = torch.zeros((C * nverts, 3), device="cuda")
    bins = bl._luma_bins(luma, SL).to(torch.int32)
    il_b, c_b, tc_b = bl.bls_reblock(bins, SS, -1), bl.bls_reblock(c, SS), bl.bls_reblock(tc, SS)
    vid_b = (il_b.long().clamp(min=0)
             + torch.arange(n_cells, device="cuda").repeat_interleave(SS)[None, :, None] * L)
    flat_b = (vid_b + torch.arange(C, device="cuda").reshape(C, 1, 1) * nverts).reshape(-1)
    src_b = torch.stack([(il_b >= 0).float(), c_b, tc_b], dim=-1).reshape(-1, 3)

    shape2 = (SIZE2D, SIZE2D)
    ext2 = bl._grid_extents(shape2, SS2D, SL2D)
    sp2, L2 = ext2[:-1], ext2[-1]
    luma2 = torch.randint(0, 256, (1,) + shape2, generator=gen).float().cuda()
    t2, c2 = (torch.rand((1,) + shape2, generator=gen).cuda() for _ in range(2))
    il2 = bl._blocked_pixel_view(bl._luma_bins(luma2, SL2D).to(torch.int32), SS2D, sp2,
                                 -1).contiguous()
    c2b = bl._blocked_pixel_view(c2, SS2D, sp2).contiguous()
    tc2b = bl._blocked_pixel_view(t2 * c2, SS2D, sp2).contiguous()
    yl2 = torch.randn((1, il2.shape[1], L2), generator=gen).cuda()
    vid2 = (il2.long().clamp(min=0)
            + torch.arange(il2.shape[1], device="cuda")[None, :, None] * L2).reshape(1, -1)
    lat_wg = torch.randn((WG_CLASSES,) + bl._grid_extents((WG_SIZE,) * 3, SS, SL),
                         generator=gen).cuda()
    lat2 = torch.randn((1,) + ext2, generator=gen).cuda()
    vox, slots, lattice = luma.numel(), il_b.numel(), lat.numel()
    return [
        ("bls_splat", "index_add_", lambda: bl.bls_splat(luma, t, c, SS, SL),
         lambda: acc.zero_().index_add_(0, flat_ids, src), 4 * (3 * vox + 3 * lattice)),
        ("bls_slice", "gather", lambda: bl.bls_slice(luma, yl, SS, SL),
         lambda: torch.gather(yl.reshape(C, -1), 1, vid.reshape(C, -1)),
         4 * (2 * vox + lattice)),
        ("bls_blur", "copy_blur", lambda: bl.bls_blur(lat), copy_floor(lattice), 8 * lattice),
        ("bls_blur_wholegrid", "copy_blur_wholegrid", lambda: bl.bls_blur(lat_wg),
         copy_floor(lat_wg.numel()), 8 * lat_wg.numel()),
        ("bls_blur_2d", "copy_blur_2d", lambda: bl.bls_blur(lat2, 5), copy_floor(lat2.numel()),
         8 * lat2.numel()),
        ("bls_reblock", "copy_reblock", lambda: bl.bls_reblock(c, SS),
         copy_floor((vox + slots) // 2), 4 * (vox + slots)),
        ("bls_unreblock", "copy_unreblock", lambda: bl.bls_unreblock(c_b, SS, shape),
         copy_floor((vox + slots) // 2), 4 * (vox + slots)),
        ("bls_splat_blocked", "index_add_blocked",
         lambda: bl.bls_splat_blocked(il_b, c_b, tc_b, L, SS),
         lambda: acc.zero_().index_add_(0, flat_b, src_b), 4 * (3 * slots + 3 * lattice)),
        ("bls_slice_blocked", "gather_blocked", lambda: bl.bls_slice_blocked(il_b, yl, SS),
         lambda: torch.gather(yl.reshape(C, -1), 1, vid_b.reshape(C, -1)),
         4 * (2 * slots + lattice)),
        ("bls_splat_blocked_2d", None, lambda: bl.bls_splat_blocked(il2, c2b, tc2b, L2), None,
         4 * (3 * il2.numel() + 3 * yl2.numel())),
        ("bls_slice_blocked_2d", "gather_2d", lambda: bl.bls_slice_blocked(il2, yl2),
         lambda: torch.gather(yl2.reshape(1, -1), 1, vid2), 4 * (2 * il2.numel() + yl2.numel())),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose vittf_tpu_torch is timed (default: this one)")
    ap.add_argument("--only", default="", help="comma-separated kernel names")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bilateral_timing: no CUDA device is visible", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    bl = importlib.import_module("vittf_tpu_torch.ops.bilateral")
    kernels = importlib.import_module("vittf_tpu_torch.kernels")
    if root not in Path(bl.__file__).resolve().parents:
        raise RuntimeError(f"imported {bl.__file__}, not the package under {root}: run the "
                           "script by its path to time another checkout")
    timing = load_timing()
    kernels.load_library()
    print(f"timing the kernels of {root} ({kernels.library_path().name}, build+load "
          f"{kernels.build_seconds} s)")
    only = set(filter(None, args.only.split(",")))
    for name, lib_name, fn, lib_fn, nbytes in cases(bl, timing.copy_floor):
        if only and name not in only:
            continue
        turns = [(name, fn)] + ([(lib_name, lib_fn)] * 2 if lib_fn else []) + [(name, fn)]
        got: dict[str, list[dict]] = {}
        for who, f in turns:
            got.setdefault(who, []).append(readings(f, timing))
        for who, rs in got.items():
            print(json.dumps({"case": who, **{k: [r[k] for r in rs] for k in rs[0]
                                              if k != "kernels"}, "kernels": rs[0]["kernels"],
                              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
