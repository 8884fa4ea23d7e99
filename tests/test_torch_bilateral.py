"""Port parity: vittf_tpu_torch.ops.bilateral (and the Sobel confidence) vs
vittf_tpu on CPU.

On CPU tensors the splat, slice and blur wrappers run their plain twins; the
CUDA kernels (K4, K5, K8 in ``csrc/bilateral.cu``) are held against the same
twins on the card by ``chip_smoke.py``. The JAX side runs as its own CPU
tests run it: the Pallas kernels in interpret mode, the solver in its CPU
default lowering (``pixel_impl='scan'``). The blocked form (K6, K7), the 2-D
solver and coarse-to-fine are in ``tests/test_torch_blocked.py``.
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


@pytest.mark.parametrize("shape,ss,sl", [((11, 9, 13), 4, 8), ((8, 8, 8), 4, 8),
                                         ((19, 23, 53), 7, 5), ((5, 9, 30), 7, 5)],
                         ids=["shape0", "shape1", "refine-grid-ragged", "refine-grid-one-z-cell"])
def test_slice_plain_matches_pallas_interpret(shape, ss, sl):
    """Ragged and divisible crops, and the refinement's grid (sigma 7 / 5) on
    a ragged crop whose rows (X = 53) are no multiple of four and on a crop
    whose z axis is one cell, there with knife-edge voxels: the largest
    floats below the bin edges 5, 10, 35 and 255 stay in the lower bin."""
    ext = jb._grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    luma, _, _ = _planes(shape, 2)
    if sl == 5:
        luma[0, 0, :4] = np.nextafter(np.float32([5, 10, 35, 255]), np.float32(0))
    yl = np.random.default_rng(3).standard_normal((int(np.prod(sp_ext)), L)).astype(np.float32)
    want = np.asarray(jb._slice_fused3d_pallas(
        jb._pad5d_fill(jnp.asarray(luma), ss, sp_ext, -2.0 * sl), jnp.asarray(yl),
        sl, ss, sp_ext, L, interpret=True,
    )).reshape(sp_ext[0] * ss, sp_ext[1] * ss, shape[2])[: shape[0], : shape[1]]
    got = tb.bls_slice_plain(torch.from_numpy(luma[None]), torch.from_numpy(yl[None]), ss, sl)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize(
    "blur_dim,lattice,batch",
    [(6, (3, 4, 5, 6), 1), (5, (4, 5, 7), 1), (5, (9, 37), 1), (6, (3, 2, 1, 37), 1),
     (6, (4, 3, 5, 52), 5)],
    ids=["6-lattice0", "5-lattice1", "5-rank2", "6-L37-X1", "6-five-classes"])
def test_blur_plain_matches_jax(blur_dim, lattice, batch):
    """``bls_blur`` on CPU tensors (its plain twin ``_blur``, which the K8
    kernel equals bit for bit on the card) vs the XLA ``_blur`` class by
    class, bit-equal: the same order of additions. For 4-D lattices also vs
    the Pallas kernel in interpret mode, which sums in another order (rtol
    1e-6, atol 1e-5)."""
    y = np.random.default_rng(4).standard_normal((batch,) + lattice).astype(np.float32)
    got = tb.bls_blur(torch.from_numpy(y), blur_dim).numpy()
    for k in range(batch):
        np.testing.assert_array_equal(got[k], np.asarray(jb._blur(jnp.asarray(y[k]), blur_dim)))
        if len(lattice) == 4:
            want = np.asarray(jb._blur_pallas4d(jnp.asarray(y[k]), blur_dim, interpret=True))
            np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-5)


def test_div_magic_divides_like_floor_division():
    """The slices' multiply-high constants (``_div_magic``, the kernels'
    ``Magic``) against ``//``: every divisor 1-4096 and 1000 seeded ones up to
    2**31 - 1, at numerators 0, d - 1, d, the multiples of d next to
    2**31 - 1, 2**31 - 1 itself and 10 000 seeded values below 2**31."""
    rng = np.random.default_rng(0)
    rand_n = rng.integers(0, 2**31, 10_000).astype(np.uint64)
    divisors = list(range(1, 4097)) + rng.integers(4097, 2**31, 1000).tolist() + [2**31 - 1]
    for d in divisors:
        m, s = tb._div_magic(d)
        assert m < 2**32 and s <= 62
        q = (2**31 - 1) // d
        edges = np.array([0, d - 1, d, (q - 1) * d, q * d - 1, q * d, 2**31 - 1], np.uint64)
        n = np.concatenate([edges, rand_n])
        got = (n * np.uint64(m)) >> np.uint64(s)
        np.testing.assert_array_equal(got, n // np.uint64(d), err_msg=f"d = {d}")
        assert tb._magic_word(d) == m | s << 32
    for d in (0, 2**31):
        with pytest.raises(ValueError):
            tb._div_magic(d)


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
    The 2-D rank runs with the 2-D blur dim 5. In 3-D ``'auto'`` on the CPU
    is the scatter form itself; in 2-D it is the blocked form, which sums a
    cell's pixels in another order, so it is held to the tolerance between
    lowerings."""
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
    scatter = tb.bilateral_solve_gray(*args, pixel_impl="scatter", **kw).numpy()
    if rank == 3:
        np.testing.assert_array_equal(scatter, got)
    else:
        np.testing.assert_allclose(scatter, got, rtol=2e-4, atol=2e-4)


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
    """The TPU-only lowerings and unknown names; the split form goes by
    ``'reblock'`` here."""
    args = [torch.from_numpy(gray_volume.astype(np.float32))] * 3
    for impl in ("scan", "pallas_interpret", "gather"):
        with pytest.raises(ValueError, match="unknown pixel_impl"):
            tb.bilateral_solve_gray(*args, pixel_impl=impl)


def _ordered_splat_model(luma, t, c, ss, sl):
    """The order the card's splat (K4) promises, written out in numpy: every
    lattice vertex is the fp32 sum of its voxels taken one after the other in
    ascending flat voxel index, t·c rounded before it is added. (3, nverts)."""
    shape = luma.shape
    ext = tb._grid_extents(shape, ss, sl)
    idx = np.indices(shape)
    vid = np.zeros(shape, np.int64)
    for ax in range(len(shape)):
        vid = vid * ext[ax] + idx[ax] // ss
    vid = (vid * ext[-1] + (luma / np.float32(sl)).astype(np.int64)).reshape(-1)
    out = np.zeros((3, int(np.prod(ext))), np.float32)
    planes = (np.ones(vid.shape, np.float32), c.reshape(-1), (t * c).astype(np.float32).reshape(-1))
    for k, plane in enumerate(planes):
        for v, x in zip(vid, plane):  # one add at a time, in voxel order, in fp32
            out[k, v] = np.float32(out[k, v] + x)
    return out


@pytest.mark.parametrize("shape,ss,sl", [((11, 9, 13), 4, 8), ((7, 6, 5), 7, 5), ((13, 10), 3, 8)])
def test_splat_plain_on_cpu_sums_in_ascending_voxel_order(shape, ss, sl):
    """``bls_splat_plain`` on CPU tensors equals the order-fixed model bit for
    bit: it is the yardstick the card's kernel is held to exactly."""
    luma, t, c = _planes(shape, 11)
    want = _ordered_splat_model(luma, t, c, ss, sl)
    got = tb.bls_splat_plain(*(torch.from_numpy(a[None]) for a in (luma, t, c)), ss, sl)
    np.testing.assert_array_equal(got[0].reshape(3, -1).numpy(), want)


def test_splat_plain_matches_pallas_interpret_on_a_ragged_crop():
    """The 61 x 47 x 53 crop of the card's check at the refinement's grid
    (sigma 7 / 5): no axis is a multiple of the cell."""
    shape, ss, sl = (61, 47, 53), 7, 5
    ext = jb._grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    luma, t, c = _planes(shape, 12)
    want = np.asarray(jb._splat_fused3d_pallas(
        jb._pad5d_fill(jnp.asarray(luma), ss, sp_ext, -2.0 * sl),
        jb._pad5d_fill(jnp.asarray(t), ss, sp_ext, 0),
        jb._pad5d_fill(jnp.asarray(c), ss, sp_ext, 0),
        sl, ss, sp_ext, L, interpret=True,
    ))
    got = tb.bls_splat_plain(*(torch.from_numpy(a[None]) for a in (luma, t, c)), ss, sl)[0].numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].sum() == np.prod(shape)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-5)


def test_splat_plain_repeats_bit_for_bit():
    luma, t, c = (torch.from_numpy(a[None]) for a in _planes((17, 20, 13), 13))
    torch.testing.assert_close(tb.bls_splat_plain(luma, t, c, 4, 8),
                               tb.bls_splat_plain(luma, t, c, 4, 8), rtol=0, atol=0)
