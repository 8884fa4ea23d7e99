"""The refine core as one graph per crop key (vittf_tpu_torch.pipeline.refine),
and the per-shape constants the refinement keeps on the device, on the CPU.

On CUDA tensors in a kernel form ``refine_similarities_batched`` runs each
class chunk's crop → Sobel → solve → write-back → quantize through the
graph cache (``utils/cuda_graphs.py``) under one key per (device, C,
sim_shape, crop_shape, form, static arguments), the crop starts a device
input; ``chip_smoke.py::phase_core_witness`` holds every graphed core on
the card ``torch.equal`` to the slice-based ``_refine_batched_core``. Here:
the key, the index-arithmetic core against the slice-based one at starts
on every face (``torch.equal``, both on CPU tensors) and against the JAX
twin's ``_refine_batched_device``, and the cached resize weights and
extent against freshly built ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.pipeline import refine as jr
from vittf_tpu_torch.ops import bilateral as tb
from vittf_tpu_torch.ops import resize as trs
from vittf_tpu_torch.ops import sampling as tsm
from vittf_tpu_torch.pipeline import refine as tr

CUDA0 = torch.device("cuda", 0)
SOLVE_KW = dict(sigma_spatial=3, sigma_luma=5, lam=256.0, cg_maxiter=25, coarse_to_fine=False,
                fine_maxiter=10, pixel_impl="auto")


def _u8_close(got, want):
    """tests/test_torch_refine.py's contract: |Δ| ≤ 1 modulo the wraparound,
    and the voxels that differ hold one value in each map."""
    d = (got.astype(np.int32) - want.astype(np.int32)) % 256
    d = np.minimum(d, 256 - d)
    assert d.max() <= 1, d.max()
    for c in range(got.shape[0]):
        diff = d[c] > 0
        assert len(np.unique(got[c][diff])) <= 1 and len(np.unique(want[c][diff])) <= 1


def _core_case(seed, C=4, sim_shape=(14, 12, 10)):
    """Smooth similarity maps (a blob per class plus noise) and a uint8
    reference with the blobs brighter than the background."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.mgrid[tuple(slice(0, s) for s in sim_shape)]).astype(np.float32)
    ref = np.full(sim_shape, 60.0, np.float32)
    sims = np.zeros((C,) + sim_shape, np.float32)
    for c in range(C):
        center = rng.uniform(2, np.asarray(sim_shape) - 2).astype(np.float32)
        inside = ((grid - center[:, None, None, None]) ** 2).sum(0) < rng.uniform(6, 16)
        ref[inside] = 120.0 + 30.0 * c
        sims[c] = np.clip(inside + 0.2 * rng.standard_normal(sim_shape), 0, 1)
    ref = np.clip(ref + 8.0 * rng.standard_normal(sim_shape), 0, 255).astype(np.uint8)
    return sims, ref


# crop starts as shares of the room the crop leaves: low faces, high faces, mixed, inside
STARTS = {
    "low faces": [(0, 0, 0)] * 4,
    "high faces": [(1, 1, 1)] * 4,
    "mixed faces": [(0, 1, 1), (1, 0, 0), (1, 1, 0), (0, 0, 1)],
    "inside": [(0.5, 0.3, 0.6), (0.2, 0.7, 0.4), (0.6, 0.5, 0.1), (0.4, 0.1, 0.9)],
}


def _starts(shares, sim_shape, crop):
    return np.rint(np.asarray(shares) * (np.asarray(sim_shape) - np.asarray(crop))).astype(np.int64)


@pytest.mark.parametrize("where", list(STARTS))
@pytest.mark.parametrize("crop", [(8, 6, 10), (14, 5, 4)])
def test_indexed_core_equals_the_slice_core(where, crop):
    """The index-arithmetic core (gather, then a scatter with no
    accumulation) is the slice-based core bit for bit, at starts on every
    face of the grid; the crops (8, 6, 10) and (14, 5, 4) span a whole axis."""
    sims_np, ref_np = _core_case(3)
    sims, ref = torch.from_numpy(sims_np), torch.from_numpy(ref_np)
    starts = _starts(STARTS[where], sims.shape[1:], crop)
    got = tr._refine_indexed_core(sims, ref, torch.from_numpy(starts), crop, SOLVE_KW)
    want = tr._refine_batched_core(sims, ref, starts, crop, SOLVE_KW)
    assert got.dtype == torch.uint8 and got.shape == sims.shape
    assert torch.equal(got, want)
    assert torch.equal(tr._refine_core(sims, ref, torch.from_numpy(starts), crop, SOLVE_KW), want)


def _c2f_case():
    """tests/test_bilateral.py::test_refine_batched_coarse_to_fine's case
    (tests/test_torch_refine.py holds the batched refinement to the JAX
    twin's on it), as the core's inputs: maps and the uint8 reference."""
    rng = np.random.default_rng(12)
    zz, yy, xx = np.mgrid[:12, :12, :12]
    b0 = ((zz - 5) ** 2 + (yy - 5) ** 2 + (xx - 5) ** 2) < 4 ** 2
    b1 = ((zz - 4) ** 2 + (yy - 8) ** 2 + (xx - 7) ** 2) < 3 ** 2
    volhalf = np.where(b0, 0.9, np.where(b1, 0.6, 0.3))
    vol = (np.kron(volhalf, np.ones((2, 2, 2)))
           + 0.03 * rng.standard_normal((24, 24, 24))).astype(np.float32)
    sims = np.stack([np.clip(b + 0.15 * rng.standard_normal(b.shape), 0, 1)
                     for b in (b0, b1)]).astype(np.float32)
    return sims, tr.make_bls_reference(vol, (12, 12, 12)).numpy()


@pytest.mark.parametrize("case", ["direct", "coarse_to_fine"])
def test_indexed_core_matches_the_jax_core(case):
    """The port's core on CPU tensors against the JAX twin's jitted
    ``_refine_batched_device`` on the same inputs and starts, at
    tests/test_torch_refine.py's uint8 contract; coarse-to-fine on that
    file's coarse-to-fine case."""
    if case == "direct":
        sims_np, ref_np = _core_case(5)
        crop, kw = (8, 8, 8), SOLVE_KW
        starts = _starts(STARTS["mixed faces"], sims_np.shape[1:], crop)
    else:
        sims_np, ref_np = _c2f_case()
        crop, kw = (8, 8, 8), {**SOLVE_KW, "sigma_spatial": 7, "coarse_to_fine": True}
        starts = np.array([[1, 1, 1], [0, 4, 3]])
    got = tr._refine_core(torch.from_numpy(sims_np), torch.from_numpy(ref_np),
                          torch.from_numpy(starts), crop, kw)
    want = jr._refine_batched_device(jnp.asarray(sims_np), jnp.asarray(ref_np),
                                     jnp.asarray(starts.astype(np.int32)), crop, **kw)
    _u8_close(got.numpy(), np.asarray(want))


def _core_key(**over):
    args = dict(device=CUDA0, shape=(4, 14, 12, 10), crop_shape=(8, 6, 10), solve_kw=SOLVE_KW)
    kw = {**SOLVE_KW}
    for name, value in over.items():
        if name in args:
            args[name] = value
        else:
            kw[name] = value
    args["solve_kw"] = kw
    return tr._core_key(**args)


def test_core_key_holds_what_jax_takes_as_static():
    """C, sim_shape, crop_shape, the form and the static arguments; 2-D and
    defaults as the solve's key (``_graph_key``)."""
    key = _core_key()
    assert key[:5] == ("refine core", (14, 12, 10), 0, (4, 8, 6, 10), "fused")
    assert key == _core_key(shape=torch.Size((4, 14, 12, 10)), crop_shape=[8, 6, 10])
    # an argument the caller leaves out takes the solve's default: the same key
    assert _core_key(cg_tol=1e-5) == key


@pytest.mark.parametrize("change", [
    ("C", None), ("sim_shape", None), ("crop_shape", (8, 6, 8)), ("pixel_impl", "reblock"),
    ("device", torch.device("cuda", 1)),
] + [(name, None) for name in tb._STATIC_ARGS])
def test_core_key_differs_for_each_static_argument(change):
    """One case per shape and per name of ``_STATIC_ARGS`` (the JAX twin's
    ``static_argnames``), the form and the device."""
    name, value = change
    bumped = {"sigma_spatial": 4, "sigma_luma": 6, "lam": 128.0, "A_diag_min": 1e-4,
              "cg_tol": 1e-6, "cg_maxiter": 26, "bistoch_iters": 9, "blur_dim": 5,
              "coarse_to_fine": True, "fine_maxiter": 25}
    if name == "C":
        over = {"shape": (3, 14, 12, 10)}
    elif name == "sim_shape":
        over = {"shape": (4, 14, 12, 12)}
    elif name in bumped:
        over = {name: bumped[name]}
    else:
        over = {{"crop_shape": "crop_shape", "device": "device"}.get(name, name): value}
    assert _core_key(**over) != _core_key()


def test_core_key_is_the_same_for_other_starts(monkeypatch):
    """Two batched refinements whose classes crop at other starts to one
    bucketed shape give one key: the starts reach the core as an input."""
    seen = []
    real = tr._refine_core

    def spy(sims, vol_u8, starts, crop_shape, solve_kw):
        seen.append((tr._core_key(CUDA0, sims.shape, crop_shape, solve_kw), starts.clone()))
        return real(sims, vol_u8, starts, crop_shape, solve_kw)

    monkeypatch.setattr(tr, "_refine_core", spy)
    sims = np.zeros((2, 24, 24, 24), np.float32)
    sims[0, 4:9, 5:10, 3:8] = 0.8
    sims[1, 13:18, 12:17, 14:19] = 0.6
    ref = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (24,) * 3).astype(np.uint8))
    for moved in (sims, np.roll(sims, (1, -2), axis=(1, 2))):
        tr.refine_similarities_batched(torch.from_numpy(moved), None, (24, 24, 24), ref_u8=ref)
    (key_a, starts_a), (key_b, starts_b) = seen
    assert key_a == key_b and not torch.equal(starts_a, starts_b)


def test_crop_index_is_the_slices_of_every_class():
    starts = torch.tensor([[0, 1, 2], [3, 0, 1]])
    idx = tr._crop_index(starts, (2, 3, 4), (5, 4, 6))
    grid = torch.arange(5 * 4 * 6).reshape(5, 4, 6)
    for c, (x, y, z) in enumerate(starts.tolist()):
        assert torch.equal(idx[c], grid[x:x + 2, y:y + 3, z:z + 4].reshape(-1))


@pytest.mark.parametrize("kind,args", [
    ("linear", (16, 7, None)), ("linear", (5, 12, None)), ("cubic", (9, 14, None)),
    ("cubic", (8, 16, 0.4878)), ("adaptive_avg", (13, 4, None)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_resize_weights_equal_fresh_ones(kind, args, dtype):
    """A cached matrix is the one built afresh, bit for bit, and it is
    built once: a second lookup hands back the same tensor."""
    in_size, out_size, scale = args
    fresh = trs._MATRICES[kind](*((in_size, out_size) if scale is None else args))
    got = trs._axis_weights(kind, in_size, out_size, scale, dtype, torch.device("cpu"))
    assert torch.equal(got, torch.as_tensor(fresh, dtype=dtype))
    assert trs._axis_weights(kind, in_size, out_size, scale, dtype, torch.device("cpu")) is got


def test_resize_through_cached_weights_is_unchanged():
    """``resize_linear`` with its cached matrices equals the axis-by-axis
    tensordot with matrices built afresh."""
    x = torch.from_numpy(np.random.default_rng(1).random((2, 9, 11, 7)).astype(np.float32))
    want = x
    for axis, out in zip((1, 2, 3), (5, 16, 7)):
        if want.shape[axis] != out:
            w = torch.as_tensor(trs._linear_weight_matrix(want.shape[axis], out),
                                dtype=torch.float32)
            want = torch.movedim(torch.tensordot(w, want, dims=([1], [axis])), 0, axis)
    assert torch.equal(trs.resize_linear(x, (5, 16, 7)), want)


def test_cached_extent_equals_a_fresh_one():
    abs_coords = torch.tensor([[[0.0, 3.0, 7.0], [5.0, 1.0, 2.0]]])
    ext = tsm._extent((6, 4, 8), torch.device("cpu"))
    assert torch.equal(ext, torch.tensor((6, 4, 8), dtype=torch.float32))
    assert tsm._extent((6, 4, 8), torch.device("cpu")) is ext
    want = (abs_coords + 0.5) / torch.tensor([6.0, 4.0, 8.0]) * 2.0 - 1.0
    assert torch.equal(tsm.rel_coords_from_abs(abs_coords, np.array([6, 4, 8])), want)
