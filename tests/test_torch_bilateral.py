"""Port parity: vittf_tpu_torch.ops.bilateral (and the Sobel confidence) vs
vittf_tpu on CPU.

On CPU tensors the splat, slice and blur wrappers run their plain twins; the
CUDA kernels (K4, K5, K8 in ``csrc/bilateral.cu``) are held against the same
twins on the card by ``chip_smoke.py``. The JAX side runs as its own CPU
tests run it: the Pallas kernels in interpret mode, the solver in its CPU
default lowering (``pixel_impl='scan'``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import bilateral as jb
from vittf_tpu.ops import morphology as jm
from vittf_tpu_torch.ops import bilateral as tb
from vittf_tpu_torch.ops import morphology as tm


@pytest.fixture(scope="module")
def gray_volume():
    """tests/test_bilateral.py's fixture: a noisy bright ball, uint8."""
    rng = np.random.default_rng(7)
    z, y, x = np.mgrid[:14, :12, :10]
    base = 120 + 80 * ((z - 7) ** 2 + (y - 6) ** 2 + (x - 5) ** 2 < 20)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    luma = (rng.random(shape) * 255.0).astype(np.float32)
    return luma, rng.random(shape, np.float32), rng.random(shape, np.float32)


@pytest.mark.parametrize("shape", [(11, 9, 13), (8, 8, 8), (17, 20, 13)])
def test_splat_plain_matches_pallas_interpret(shape):
    """Ragged and divisible crops; two batch entries, each against the
    Pallas kernel run on its own. Counts are exact, the sums fp32 summation
    order apart (rtol 1e-5)."""
    ss, sl = 4, 8
    ext = jb._grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    batch = [_planes(shape, seed) for seed in (0, 1)]
    got = tb.bls_splat_plain(
        *(torch.from_numpy(np.stack([b[i] for b in batch])) for i in range(3)), ss, sl
    ).numpy()
    assert got.shape == (2, 3, int(np.prod(sp_ext)), L)
    for k, (luma, t, c) in enumerate(batch):
        want = np.asarray(jb._splat_fused3d_pallas(
            jb._pad5d_fill(jnp.asarray(luma), ss, sp_ext, -2.0 * sl),
            jb._pad5d_fill(jnp.asarray(t), ss, sp_ext, 0),
            jb._pad5d_fill(jnp.asarray(c), ss, sp_ext, 0),
            sl, ss, sp_ext, L, interpret=True,
        ))
        np.testing.assert_array_equal(got[k, 0], want[0])
        assert got[k, 0].sum() == np.prod(shape)
        np.testing.assert_allclose(got[k, 1:], want[1:], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(11, 9, 13), (8, 8, 8)])
def test_slice_plain_matches_pallas_interpret(shape):
    ss, sl = 4, 8
    ext = jb._grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    luma, _, _ = _planes(shape, 2)
    yl = np.random.default_rng(3).standard_normal((int(np.prod(sp_ext)), L)).astype(np.float32)
    want = np.asarray(jb._slice_fused3d_pallas(
        jb._pad5d_fill(jnp.asarray(luma), ss, sp_ext, -2.0 * sl), jnp.asarray(yl),
        sl, ss, sp_ext, L, interpret=True,
    )).reshape(sp_ext[0] * ss, sp_ext[1] * ss, shape[2])[: shape[0], : shape[1]]
    got = tb.bls_slice_plain(torch.from_numpy(luma[None]), torch.from_numpy(yl[None]), ss, sl)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("blur_dim,lattice", [(6, (3, 4, 5, 6)), (5, (4, 5, 7))])
def test_blur_plain_matches_jax(blur_dim, lattice):
    """vs the XLA ``_blur`` (the same order of additions) and, for the 4-D
    lattice, the Pallas kernel in interpret mode, which sums in another
    order (rtol 1e-6, atol 1e-5)."""
    y = np.random.default_rng(4).standard_normal(lattice).astype(np.float32)
    got = tb._blur(torch.from_numpy(y[None]), blur_dim)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jb._blur(jnp.asarray(y), blur_dim)),
                               rtol=1e-6, atol=1e-5)
    if len(lattice) == 4:
        want = np.asarray(jb._blur_pallas4d(jnp.asarray(y), blur_dim, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_luma_bins_divide_at_knife_edges():
    """A value just below a bin edge stays in the lower bin: true division,
    where a multiply by the fp32 reciprocal 0.2 would round it up."""
    edges = np.array([5.0, 10.0, 255.0, 35.0], np.float32)
    luma = np.concatenate([np.nextafter(edges, np.float32(0)), edges])
    want = (luma / np.float32(5)).astype(np.int64)
    got = tb._luma_bins(torch.from_numpy(luma), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == edges / 5 - 1).all()


@pytest.mark.parametrize("rank", [3, 2])
def test_bilateral_solve_gray_matches_jax(gray_volume, rank):
    """vs JAX's CPU default lowering at 2e-4, the tolerance the JAX suite
    holds between its own lowerings (tests/test_bilateral.py:236, :285).
    The 2-D rank runs with the 2-D blur dim 5."""
    rng = np.random.default_rng(6)
    if rank == 3:
        luma = gray_volume.astype(np.float32)
        kw = dict(sigma_spatial=4, sigma_luma=8)
    else:
        luma = gray_volume[:, :, 5].astype(np.float32)
        kw = dict(sigma_spatial=3, sigma_luma=8, blur_dim=jb._BLUR_DIM_2D)
    t = (luma > 150).astype(np.float32)
    c = rng.random(luma.shape).astype(np.float32) * 0.5 + 0.4
    want = np.asarray(jb.bilateral_solve_gray(
        jnp.asarray(t), jnp.asarray(luma), jnp.asarray(c), pixel_impl="scan", **kw))
    args = [torch.from_numpy(a) for a in (t, luma, c)]
    got = tb.bilateral_solve_gray(*args, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(
        tb.bilateral_solve_gray(*args, pixel_impl="scatter", **kw).numpy(), got)


def test_batched_solve_matches_one_by_one(gray_volume):
    """The leading class axis (JAX's vmap) changes nothing per class, also
    when one class has an all-zero target and converges at once."""
    rng = np.random.default_rng(8)
    luma = np.stack([gray_volume, np.roll(gray_volume, 3, 0), gray_volume]).astype(np.float32)
    t = np.stack([(luma[0] > 150), rng.random(luma.shape[1:]) > 0.5,
                  np.zeros(luma.shape[1:])]).astype(np.float32)
    c = (rng.random(luma.shape) * 0.5 + 0.4).astype(np.float32)
    kw = dict(sigma_spatial=4, sigma_luma=8)
    got = tb.bilateral_solve_gray_batched(*map(torch.from_numpy, (t, luma, c)), **kw).numpy()
    for k in range(3):
        one = tb.bilateral_solve_gray(*(torch.from_numpy(a[k]) for a in (t, luma, c)), **kw)
        np.testing.assert_allclose(got[k], one.numpy(), rtol=1e-6, atol=1e-7)
    assert (got[2] == 0).all()


def test_apply_bilateral_solver3d_matches_jax(gray_volume):
    rng = np.random.default_rng(3)
    t = np.clip((gray_volume > 150) + rng.normal(0, 0.3, gray_volume.shape), 0, 1)
    t = t.astype(np.float32)[None]
    r = np.broadcast_to(gray_volume[None], (3,) + gray_volume.shape)
    gp = {"sigma_spatial": 4, "sigma_luma": 8}
    want = np.asarray(jb.apply_bilateral_solver3d(jnp.asarray(t), jnp.asarray(r), grid_params=gp))
    got = tb.apply_bilateral_solver3d(torch.from_numpy(t), torch.from_numpy(r.copy()),
                                      grid_params=gp).numpy()
    assert got.shape == gray_volume.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bilateral_filter_gray_matches_jax(gray_volume):
    x = np.random.default_rng(1).random(gray_volume.shape).astype(np.float32)
    luma = gray_volume.astype(np.float32)
    want = np.asarray(jb.bilateral_filter_gray(jnp.asarray(x), jnp.asarray(luma), 4, 8))
    got = tb.bilateral_filter_gray(torch.from_numpy(x), torch.from_numpy(luma), 4, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sobel_and_gauss_match_jax():
    x = np.random.default_rng(5).random((2, 1, 6, 7, 8)).astype(np.float32)
    for name in ("filter_sobel_separated", "filter_gauss_separated"):
        want = np.asarray(getattr(jm, name)(jnp.asarray(x)))
        got = getattr(tm, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cpu_wrappers_are_plain_and_not_counted():
    luma, t, c = (torch.from_numpy(a[None]) for a in _planes((9, 10, 11), 9))
    before = (tb.bls_splat.launches, tb.bls_slice.launches, tb.bls_blur.launches)
    grid = tb.bls_splat(luma, t, c, 4, 8)
    torch.testing.assert_close(grid, tb.bls_splat_plain(luma, t, c, 4, 8), rtol=0, atol=0)
    vals = grid[:, 1]
    torch.testing.assert_close(tb.bls_slice(luma, vals, 4, 8),
                               tb.bls_slice_plain(luma, vals, 4, 8), rtol=0, atol=0)
    lat = vals.reshape(1, 3, 3, 3, -1)
    torch.testing.assert_close(tb.bls_blur(lat), tb._blur(lat), rtol=0, atol=0)
    assert (tb.bls_splat.launches, tb.bls_slice.launches, tb.bls_blur.launches) == before


def test_unported_lowerings_are_refused(gray_volume):
    args = [torch.from_numpy(gray_volume.astype(np.float32))] * 3
    with pytest.raises(NotImplementedError, match="coarse-to-fine"):
        tb.bilateral_solve_gray(*args, coarse_to_fine=True)
    for impl in ("scan", "pallas_reblock", "gather"):
        with pytest.raises(ValueError, match="unknown pixel_impl"):
            tb.bilateral_solve_gray(*args, pixel_impl=impl)
