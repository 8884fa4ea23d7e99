"""Port parity: the refinement slice (crop, resize, pipeline/refine.py and the
bilateral branch of compute_similarities) vs vittf_tpu on CPU.

The port's CPU path runs the plain scatter/gather twins of the kernels; the
JAX package runs its CPU default (the 'scan' lowering), so refined floats
agree to fp32 summation order (2e-4, the JAX suite's tolerance between its
own lowerings). uint8 maps may then differ by 1 where such a difference
moves a value across an integer quantization boundary (255 → 0 across the
reference's wraparound at 256 counts as 1). The solve's output is constant
over the voxels of one lattice vertex, so one knife edge moves all of them
together: up to σ_s³ = 343 voxels, more than 1e-3 of these small grids. The
contract here is therefore that the voxels that differ hold one value in
each map (one boundary crossed); ``chip_smoke.py`` holds the kernels to
"|Δ| ≤ 1 on at most 1e-3 of the voxels" at its larger sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import crop as jc
from vittf_tpu.ops import resize as jrs
from vittf_tpu.pipeline import ntf as jn
from vittf_tpu.pipeline import refine as jr
from vittf_tpu_torch.ops import crop as tc
from vittf_tpu_torch.ops import resize as trs
from vittf_tpu_torch.pipeline import ntf as tn
from vittf_tpu_torch.pipeline import refine as tr


def _assert_u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    d = (got.astype(np.int32) - want.astype(np.int32)) % 256
    d = np.minimum(d, 256 - d)
    assert d.max() <= 1, d.max()
    for c in range(got.shape[0]) if got.ndim == 4 else [slice(None)]:
        diff = d[c] > 0
        assert len(np.unique(got[c][diff])) <= 1 and len(np.unique(want[c][diff])) <= 1


def _blob_case(seed, sim_shape=(16, 16, 16), n_cls=3):
    """A volume of three bright blobs at twice the sim grid and one noisy
    similarity map per blob; the last class is all zero (an empty class)."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.mgrid[tuple(slice(0, s) for s in sim_shape)]).astype(np.float32)
    vol_half = np.full(sim_shape, 0.3, np.float32)
    sims = np.zeros((n_cls,) + tuple(sim_shape), np.float32)
    for c in range(n_cls - 1):
        center = rng.uniform(4, 12, 3).astype(np.float32)
        d2 = ((grid - center[:, None, None, None]) ** 2).sum(0)
        r2 = rng.uniform(9, 20)
        vol_half[d2 < r2] = 0.5 + 0.2 * c
        noisy = np.clip((d2 < r2) + 0.15 * rng.standard_normal(sim_shape), 0, 1)
        sims[c] = noisy * (d2 < 3 * r2)  # support: a shell around the blob
    vol = np.kron(vol_half, np.ones((2, 2, 2), np.float32))
    vol += 0.03 * rng.standard_normal(vol.shape).astype(np.float32)
    return vol, sims


def test_golden_bls_refined():
    """tests/golden/bls_refined.npz through the port's refine_similarity.

    Tolerance 2e-4, not the golden test's 1e-5/1e-6: the golden was made with
    JAX's 'scan' lowering, and the port's plain twins are the 'scatter' form,
    which sums in another fp32 order; JAX's own 'scatter' form misses the
    golden by 6.8e-6 as well (the port by 5.5e-6)."""
    golden = np.load("tests/golden/bls_refined.npz")["refined"]
    rng = np.random.default_rng(77)
    vol = rng.random((20, 20, 20)).astype(np.float32)
    sim = np.zeros((10, 10, 10), np.float32)
    sim[2:8, 3:9, 2:7] = rng.random((6, 6, 5)).astype(np.float32)
    got = tr.refine_similarity(torch.from_numpy(sim), torch.from_numpy(vol), (10, 10, 10))
    assert got.dtype == torch.float32 and got.shape == (10, 10, 10)
    np.testing.assert_allclose(got.numpy(), golden, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bucket", [None, 4])
def test_refine_similarity_matches_jax(bucket):
    rng = np.random.default_rng(5)
    vol = rng.random((24, 24, 24)).astype(np.float32)
    sim = np.zeros((12, 12, 12), np.float32)
    sim[3:8, 3:9, 2:7] = rng.random((5, 6, 5)).astype(np.float32)
    want = np.asarray(jr.refine_similarity(jnp.asarray(sim), jnp.asarray(vol), (12, 12, 12),
                                           shape_bucket=bucket))
    got = tr.refine_similarity(torch.from_numpy(sim), vol, (12, 12, 12), shape_bucket=bucket)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk_voxels", [None, "1"])
def test_refine_similarities_batched_matches_jax(monkeypatch, chunk_voxels):
    """C = 3 with one empty class; a budget of one voxel forces one class per
    chunk (VITTF_BLS_CHUNK_VOXELS), read by both packages."""
    if chunk_voxels:
        monkeypatch.setenv("VITTF_BLS_CHUNK_VOXELS", chunk_voxels)
    vol, sims = _blob_case(11)
    want = np.asarray(jr.refine_similarities_batched(jnp.asarray(sims), jnp.asarray(vol),
                                                     (16, 16, 16)))
    got = tr.refine_similarities_batched(torch.from_numpy(sims), vol, (16, 16, 16))
    assert got.dtype == torch.uint8 and got.shape == (3, 16, 16, 16)
    assert (got[2] == 0).all() and got[0].any() and got[1].any()
    _assert_u8_close(got.numpy(), want)
    ref = tr.make_bls_reference(vol, (16, 16, 16))
    np.testing.assert_array_equal(ref.numpy(), np.asarray(jr.make_bls_reference(vol, (16, 16, 16))))
    torch.testing.assert_close(
        tr.refine_similarities_batched(torch.from_numpy(sims), None, (16, 16, 16), ref_u8=ref),
        got, rtol=0, atol=0)


def _c2f_case():
    """tests/test_bilateral.py::test_refine_batched_coarse_to_fine's case."""
    rng = np.random.default_rng(12)
    zz, yy, xx = np.mgrid[:12, :12, :12]
    b0 = ((zz - 5) ** 2 + (yy - 5) ** 2 + (xx - 5) ** 2) < 4 ** 2
    b1 = ((zz - 4) ** 2 + (yy - 8) ** 2 + (xx - 7) ** 2) < 3 ** 2
    volhalf = np.where(b0, 0.9, np.where(b1, 0.6, 0.3))
    vol = (np.kron(volhalf, np.ones((2, 2, 2)))
           + 0.03 * rng.standard_normal((24, 24, 24))).astype(np.float32)
    sims = np.stack([np.clip(b + 0.15 * rng.standard_normal(b.shape), 0, 1)
                     for b in (b0, b1)]).astype(np.float32)
    return vol, sims


@pytest.mark.parametrize("how", ["bs_params", "env", "fine_maxiter"])
def test_refine_batched_coarse_to_fine_matches_jax(monkeypatch, how):
    """``bs_params['coarse_to_fine']`` and ``VITTF_BLS_COARSE=1`` (read by
    both packages) reach the solve, with ``fine_maxiter``; the maps move
    against the direct solve's by a few quantization steps at most."""
    vol, sims = _c2f_case()
    bs = None
    if how == "env":
        monkeypatch.setenv("VITTF_BLS_COARSE", "1")
    else:
        bs = {"coarse_to_fine": True}
        if how == "fine_maxiter":
            bs.update(fine_maxiter=2, cg_maxiter=12, lam=128.0)
    want = np.asarray(jr.refine_similarities_batched(jnp.asarray(sims), jnp.asarray(vol),
                                                     (12, 12, 12), bs_params=bs))
    got = tr.refine_similarities_batched(torch.from_numpy(sims), vol, (12, 12, 12),
                                         bs_params=bs).numpy()
    _assert_u8_close(got, want)
    monkeypatch.delenv("VITTF_BLS_COARSE", raising=False)
    base = tr.refine_similarities_batched(torch.from_numpy(sims), vol, (12, 12, 12)).numpy()
    assert not np.array_equal(got, base)
    if how != "fine_maxiter":
        d = np.abs(got.astype(np.int32) - base.astype(np.int32))
        assert np.mean(d <= 3) > 0.999 and d.max() <= 8
    off = tr.refine_similarities_batched(torch.from_numpy(sims), vol, (12, 12, 12),
                                         bs_params={"coarse_to_fine": False}).numpy()
    np.testing.assert_array_equal(off, base)


def test_refine_entry_points_take_grid_and_bs_params():
    rng = np.random.default_rng(5)
    vol = rng.random((24, 24, 24)).astype(np.float32)
    sim = np.zeros((12, 12, 12), np.float32)
    sim[3:8, 3:9, 2:7] = rng.random((5, 6, 5)).astype(np.float32)
    kw = dict(grid_params={"sigma_spatial": 4, "sigma_luma": 8},
              bs_params={"lam": 64, "cg_maxiter": 10})
    want = np.asarray(jr.refine_similarity(jnp.asarray(sim), jnp.asarray(vol), (12, 12, 12), **kw))
    got = tr.refine_similarity(torch.from_numpy(sim), vol, (12, 12, 12), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    wantb = np.asarray(jr.refine_similarities_batched(jnp.asarray(sim[None]), jnp.asarray(vol),
                                                      (12, 12, 12), **kw))
    gotb = tr.refine_similarities_batched(torch.from_numpy(sim[None]), vol, (12, 12, 12), **kw)
    _assert_u8_close(gotb.numpy(), wantb)
    assert not torch.equal(gotb, tr.refine_similarities_batched(torch.from_numpy(sim[None]), vol,
                                                                (12, 12, 12)))


def test_refine_batched_all_empty_and_boxes():
    sims = np.zeros((2, 8, 8, 8), np.float32)
    got = tr.refine_similarities_batched(torch.from_numpy(sims), np.ones((16, 16, 16)), (8, 8, 8))
    assert got.dtype == torch.uint8 and not got.any()
    rng = np.random.default_rng(2)
    sims = rng.random((3, 9, 10, 11)).astype(np.float32) * (rng.random((3, 9, 10, 11)) > 0.97)
    sims[1] = 0.0
    want_b, want_ne = jr._boxes_device(jnp.asarray(sims), 0.1)
    got_b, got_ne = tr._boxes_device(torch.from_numpy(sims), 0.1)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_ne.numpy(), np.asarray(want_ne) > 0)
    mima = (np.array([3, 3, 2]), np.array([10, 11, 9]))
    for bucket in (4, 8):
        for g, w in zip(tr._bucket_box(mima, (12, 12, 12), bucket),
                        jr._bucket_box(mima, (12, 12, 12), bucket)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bucket", [None, 8])
def test_compute_similarities_bls_matches_jax(bucket):
    """Both BLS modes: per-class tight crops (reference parity) and the
    batched bucketed crop; the empty class comes back all zero."""
    rng = np.random.default_rng(12)
    vol = np.kron(rng.random((4, 4, 4)), np.ones((6, 6, 6))).astype(np.float32)
    feats = (rng.standard_normal((16, 12, 12, 12)) * 0.4).astype(np.float32)
    ann = {
        "a": rng.integers(0, 24, (12, 3)).astype(np.int64),
        "b": rng.integers(0, 24, (5, 3)).astype(np.int64),
        "empty": np.zeros((0, 3), np.int64),
    }
    want = jn.compute_similarities(jnp.asarray(vol), jnp.asarray(feats), ann, impl="xla",
                                   bilateral_solver=True, bls_shape_bucket=bucket)
    got = tn.compute_similarities(vol, torch.from_numpy(feats), ann, bilateral_solver=True,
                                  bls_shape_bucket=bucket)
    for name in ann:
        assert got[name].dtype == torch.uint8 and got[name].shape == (12, 12, 12)
        _assert_u8_close(got[name].numpy(), want[name])
    assert not got["empty"].any() and got["a"].any()
    with pytest.raises(ValueError, match="volume"):
        tn.compute_similarities(vol.shape, torch.from_numpy(feats), ann, bilateral_solver=True)


def test_unclamped_quantize_of_an_all_zero_class_is_zero():
    """The per-class BLS path quantizes 255/(0.99·max)·sim with no clamp
    (vittf_tpu/pipeline/ntf.py:238-239): an all-zero map gives 255/0·0 = NaN,
    and ±inf appear where max is 0 and other values are not. Both packages
    write 0 for them."""
    x = np.array([np.nan, np.inf, -np.inf, 0.0, 255.9, 256.0], np.float32)
    got = tn.quantize_uint8_torch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jn.quantize_uint8_torch(jnp.asarray(x))))
    np.testing.assert_array_equal(got, [0, 0, 0, 0, 255, 0])
    sim = torch.zeros((4, 4, 4))
    quant = 0.99 * sim.max()
    assert not tn.quantize_uint8_torch(255.0 / quant * sim).any()


def test_crop_and_resize_linear_match_jax(rng):
    sim = rng.random((9, 11, 13)).astype(np.float32)
    sim[sim < 0.85] = 0.0
    vol = rng.random((9, 11, 13)).astype(np.float32)
    (jsim, jvol), jmima = jc.crop_pad([jnp.asarray(sim), jnp.asarray(vol)], thresh=0.1, pad=2)
    (gsim, gvol), gmima = tc.crop_pad([torch.from_numpy(sim), torch.from_numpy(vol)],
                                      thresh=0.1, pad=2)
    for g, w in zip(gmima, jmima):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(gsim.numpy(), np.asarray(jsim))
    np.testing.assert_array_equal(gvol.numpy(), np.asarray(jvol))
    src = torch.from_numpy(sim)
    out = tc.write_crop_into(src, gsim * 2, gmima)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jc.write_crop_into(jnp.asarray(sim), jsim * 2, jmima)))
    assert torch.equal(src, torch.from_numpy(sim))  # the input is not written
    mi, ma = tc.bounding_box(torch.zeros((4, 5, 6), dtype=torch.bool))
    assert list(mi) == [0, 0, 0] and list(ma) == [4, 5, 6]
    x = rng.random((2, 7, 9, 12)).astype(np.float32)
    for size in ((4, 5, 6), (14, 9, 5)):
        np.testing.assert_allclose(trs.resize_linear(torch.from_numpy(x), size).numpy(),
                                   np.asarray(jrs.resize_linear(jnp.asarray(x), size)),
                                   rtol=1e-5, atol=1e-6)
