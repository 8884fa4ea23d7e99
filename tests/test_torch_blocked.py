"""Port parity: the blocked-form bilateral path of vittf_tpu_torch (the K6
reblock/unreblock and K7 blocked splat/slice twins, ``pixel_impl='reblock'``,
the rank-2 ``'auto'`` route, the 2-D solver, hole filling and coarse-to-fine)
vs vittf_tpu on CPU.

On CPU tensors the wrappers run their plain twins; the CUDA kernels
(``csrc/bilateral_reblock.cu``) are held against the same twins on the card
by ``chip_smoke.py``. The JAX side runs its real Pallas kernels on the CPU
under ``pltpu.force_tpu_interpret_mode()``, as tests/test_similarity.py does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import ndimage

from vittf_tpu.ops import bilateral as jb
from vittf_tpu.ops import connected as jcc
from vittf_tpu.ops import morphology as jm
from vittf_tpu_torch.ops import bilateral as tb
from vittf_tpu_torch.ops import connected as tcc
from vittf_tpu_torch.ops import morphology as tm

SHAPES = [(17, 12, 20), (8, 12, 4), (5, 9, 7)]  # ragged, divisible by 4, ragged and small


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    luma = (rng.random(shape) * 255.0).astype(np.float32)
    return luma, rng.random(shape, np.float32), rng.random(shape, np.float32)


def _blocked_inputs(shape, ss, sl, seed):
    """The JAX split form's kernel inputs at rank 3: bins (fill −1), c and
    t·c through ``_reblock3d_pallas``."""
    luma, t, c = _planes(shape, seed)
    bins = (luma / np.float32(sl)).astype(np.int32)
    sp_ext = jb._grid_extents(shape, ss, sl)[:-1]
    with pltpu.force_tpu_interpret_mode():
        blocked = [np.asarray(jb._reblock3d_pallas(jnp.asarray(x), ss, sp_ext, fill=f))
                   for x, f in ((bins, -1), (c, 0), (t * c, 0))]
    return (bins, c, t * c), blocked


@pytest.mark.parametrize("shape", SHAPES + [(6, 9, 16), (9, 5, 1), (7, 5, 10), (15, 9, 22)])
@pytest.mark.parametrize("ss", [4, 7])
def test_reblock_twins_match_pallas_interpret(shape, ss):
    """K6a and K6b exactly: int32 with fill −1, fp32 with fill 0, two batch
    entries; the inverse crops back to the volume. Rows of X % 4 = 0, 1, 2
    and 3 (the kernels' 16-byte accesses or one word at a time) and a volume
    ragged against σ_s on all three axes, where the K6b kernel crops."""
    raw, want = _blocked_inputs(shape, ss, 5, 0)
    for x, w, fill in zip(raw, want, (-1, 0, 0)):
        xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
        got = tb.bls_reblock(xb, ss, fill)
        assert got.dtype == xb.dtype and tuple(got.shape[1:]) == w.shape
        np.testing.assert_array_equal(got[0].numpy(), w)
        back = tb.bls_unreblock(got, ss, shape)
        np.testing.assert_array_equal(back.numpy(), xb.numpy())
    sp_ext = jb._grid_extents(shape, ss, 5)[:-1]
    with pltpu.force_tpu_interpret_mode():
        jback = np.asarray(jb._unreblock3d_pallas(jnp.asarray(want[1]), ss, sp_ext, shape))
    np.testing.assert_array_equal(
        tb.bls_unreblock(torch.from_numpy(want[1][None].copy()), ss, shape)[0].numpy(), jback)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_blocked_splat_slice_twins_match_pallas_interpret_rank3(shape):
    """K7 with G = ss on the K6 layout: counts and slice exact, sums fp32
    summation order apart (rtol 1e-5)."""
    ss, sl = 4, 8
    ext = jb._grid_extents(shape, ss, sl)
    n_cells, L = int(np.prod(ext[:-1])), ext[-1]
    _, (il_b, c_b, tc_b) = _blocked_inputs(shape, ss, sl, 1)
    yl = np.random.default_rng(2).standard_normal((n_cells, L)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb._splat_pallas(*map(jnp.asarray, (il_b, c_b, tc_b)), L, groups=ss))
        want_sl = np.asarray(jb._slice_pallas(jnp.asarray(il_b), jnp.asarray(yl), L, groups=ss))
    got = tb.bls_splat_blocked(*(torch.from_numpy(a[None]) for a in (il_b, c_b, tc_b)), L, ss)
    assert got.shape == (1, 3, n_cells, L)
    np.testing.assert_array_equal(got[0, 0].numpy(), want[0])
    assert got[0, 0].sum() == np.prod(shape)  # fill slots (bin −1) are not counted
    np.testing.assert_allclose(got[0, 1:].numpy(), want[1:], rtol=1e-5, atol=1e-6)
    got_sl = tb.bls_slice_blocked(torch.from_numpy(il_b[None]), torch.from_numpy(yl[None]), ss)
    np.testing.assert_array_equal(got_sl[0].numpy(), want_sl)


@pytest.mark.parametrize("shape,ss,sl", [((13, 10), 4, 8), ((8, 12), 4, 8), ((9,), 4, 8),
                                         ((50, 53), 24, 4)],
                         ids=["shape0", "shape1", "shape2", "solver2d-grid"])
def test_blocked_view_and_g1_twins_match_jax(shape, ss, sl):
    """Ranks 2 and 1: ``_blocked_pixel_view`` / ``_unblock_pixel_view`` equal
    the JAX views, and K7 with G = 1 equals the Pallas kernels on them; also
    at the 2-D solver's grid (sigma 24 / 4: 576 slots a cell, 64 bins) on a
    ragged image."""
    ext = jb._grid_extents(shape, ss, sl)
    sp_ext, L = ext[:-1], ext[-1]
    luma, t, c = _planes(shape, 3)
    bins = (luma / np.float32(sl)).astype(np.int32)
    jviews = [np.asarray(jb._blocked_pixel_view(jnp.asarray(x), ss, sp_ext, fill=f))
              for x, f in ((bins, -1), (c, 0), (t * c, 0))]
    views = [tb._blocked_pixel_view(torch.from_numpy(x[None]), ss, sp_ext, f).contiguous()
             for x, f in ((bins, -1), (c, 0), (t * c, 0))]
    for got, want in zip(views, jviews):
        np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(
        tb._unblock_pixel_view(views[1], ss, sp_ext, shape)[0].numpy(), c)
    yl = np.random.default_rng(4).standard_normal((int(np.prod(sp_ext)), L)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb._splat_pallas(*map(jnp.asarray, jviews), L, groups=1))
        want_sl = np.asarray(jb._slice_pallas(jnp.asarray(jviews[0]), jnp.asarray(yl), L))
    got = tb.bls_splat_blocked(*views, L, 1)
    np.testing.assert_array_equal(got[0, 0].numpy(), want[0])
    np.testing.assert_allclose(got[0, 1:].numpy(), want[1:], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tb.bls_slice_blocked(views[0], torch.from_numpy(yl[None])).numpy()[0], want_sl)


def test_blocked_splat_ignores_bins_outside_the_lattice():
    il = torch.tensor([[[0, 3, -1, 7, 2, 2]]], dtype=torch.int32)  # L = 4: 7 and −1 add nothing
    c = torch.arange(1.0, 7.0).reshape(1, 1, 6)
    got = tb.bls_splat_blocked(il, c, 2 * c, 4)
    np.testing.assert_array_equal(got[0, :, 0].numpy(),
                                  [[1, 0, 2, 1], [1, 0, 11, 2], [2, 0, 22, 4]])
    yl = torch.tensor([[[10.0, 11.0, 12.0, 13.0]]])
    np.testing.assert_array_equal(tb.bls_slice_blocked(il, yl).numpy()[0, 0],
                                  [10, 13, 0, 0, 12, 12])


def test_cpu_blocked_wrappers_are_plain_and_not_counted():
    fns = (tb.bls_reblock, tb.bls_unreblock, tb.bls_splat_blocked, tb.bls_slice_blocked)
    before = [f.launches for f in fns]
    x = torch.from_numpy(_planes((9, 10, 11), 5)[1][None])
    xb = tb.bls_reblock(x, 4)
    torch.testing.assert_close(xb, tb.bls_reblock_plain(x, 4), rtol=0, atol=0)
    torch.testing.assert_close(tb.bls_unreblock(xb, 4, (9, 10, 11)), x, rtol=0, atol=0)
    assert [f.launches for f in fns] == before


@pytest.fixture(scope="module")
def gray_volume():
    """tests/test_bilateral.py's fixture: a noisy bright ball, uint8."""
    rng = np.random.default_rng(7)
    z, y, x = np.mgrid[:14, :12, :10]
    base = 120 + 80 * ((z - 7) ** 2 + (y - 6) ** 2 + (x - 5) ** 2 < 20)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def _solve_case(gray_volume, rank):
    rng = np.random.default_rng(6)
    if rank == 3:
        luma, kw = gray_volume.astype(np.float32), dict(sigma_spatial=4, sigma_luma=8)
    else:
        luma = gray_volume[:, :, 5].astype(np.float32)
        kw = dict(sigma_spatial=3, sigma_luma=8, blur_dim=jb._BLUR_DIM_2D)
    t = (luma > 150).astype(np.float32)
    c = rng.random(luma.shape).astype(np.float32) * 0.5 + 0.4
    return (t, luma, c), kw


@pytest.mark.parametrize("rank,port_impl,jax_impl", [(3, "reblock", "pallas_reblock"),
                                                     (2, "auto", "pallas"),
                                                     (2, "reblock", "pallas_reblock")])
def test_blocked_solve_matches_jax_pallas_interpret(gray_volume, rank, port_impl, jax_impl):
    """The split form against the JAX split form on its real kernels
    (interpret mode), at 2e-4, the tolerance the direct solve is held to; the
    port's forms agree with each other at the same tolerance."""
    arrs, kw = _solve_case(gray_volume, rank)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, arrs),
                                                  pixel_impl=jax_impl, **kw))
    args = [torch.from_numpy(a) for a in arrs]
    got = tb.bilateral_solve_gray(*args, pixel_impl=port_impl, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for other in ("auto", "scatter", "reblock"):
        np.testing.assert_allclose(
            tb.bilateral_solve_gray(*args, pixel_impl=other, **kw).numpy(), got,
            rtol=2e-4, atol=2e-4)


def test_batched_reblock_solve_matches_one_by_one(gray_volume):
    rng = np.random.default_rng(8)
    luma = np.stack([gray_volume, np.roll(gray_volume, 3, 0)]).astype(np.float32)
    t = np.stack([luma[0] > 150, rng.random(luma.shape[1:]) > 0.5]).astype(np.float32)
    c = (rng.random(luma.shape) * 0.5 + 0.4).astype(np.float32)
    kw = dict(sigma_spatial=4, sigma_luma=8, pixel_impl="reblock")
    got = tb.bilateral_solve_gray_batched(*map(torch.from_numpy, (t, luma, c)), **kw).numpy()
    for k in range(2):
        one = tb.bilateral_solve_gray(*(torch.from_numpy(a[k]) for a in (t, luma, c)), **kw)
        np.testing.assert_allclose(got[k], one.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_conf", [False, True])
def test_apply_bilateral_solver2d_matches_jax(with_conf):
    """``solved`` at 2e-4, the binary mask equal; the default confidence is
    the constant 0.999 and the blur dim 5."""
    rng = np.random.default_rng(13)
    y, x = np.mgrid[:40, :36]
    disk = (y - 18) ** 2 + (x - 17) ** 2 < 100
    ring_hole = (y - 18) ** 2 + (x - 17) ** 2 < 9
    r = np.clip(np.where(disk, 190.0, 70.0) + 8 * rng.standard_normal(disk.shape), 0, 255)
    r = r.astype(np.float32)
    t = np.clip((disk & ~ring_hole) + 0.2 * rng.standard_normal(disk.shape), 0, 1)
    t = t.astype(np.float32)
    t[2:5, 30:33] = 1.0  # a second, smaller island
    c = (rng.random(disk.shape) * 0.5 + 0.4).astype(np.float32) if with_conf else None
    gp = {"sigma_spatial": 4, "sigma_luma": 8}
    jbin, jsol = jb.apply_bilateral_solver2d(
        jnp.asarray(t[None]), jnp.asarray(r[None]), None if c is None else jnp.asarray(c),
        grid_params=gp)
    tbin, tsol = tb.apply_bilateral_solver2d(
        torch.from_numpy(t[None]), torch.from_numpy(r[None]),
        None if c is None else torch.from_numpy(c), grid_params=gp)
    assert tsol.shape == (40, 36) and tbin.dtype == torch.float32
    np.testing.assert_allclose(tsol.numpy(), np.asarray(jsol), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tbin.numpy(), np.asarray(jbin))
    assert 0 < tbin.sum() < tbin.numel()


def test_apply_bilateral_solver2d_all_ones_without_an_island():
    r = np.full((12, 10), 100.0, np.float32)
    t = np.zeros((12, 10), np.float32)
    tbin, tsol = tb.apply_bilateral_solver2d(torch.from_numpy(t), torch.from_numpy(r),
                                             grid_params={"sigma_spatial": 4})
    jbin, _ = jb.apply_bilateral_solver2d(jnp.asarray(t), jnp.asarray(r),
                                          grid_params={"sigma_spatial": 4})
    assert bool((tbin == 1).all()) and not tsol.any()
    np.testing.assert_array_equal(tbin.numpy(), np.asarray(jbin))


@pytest.mark.parametrize("shape", [(24, 20), (10, 12, 9)])
def test_binary_fill_holes_matches_scipy_and_jax(shape):
    """Random blobs with cavities, a snaking corridor longer than one burst
    of dilations, an empty and a full mask."""
    rng = np.random.default_rng(14)
    mask = ndimage.binary_dilation(rng.random(shape) > 0.8, iterations=1)
    snake = np.ones(shape[-2:], bool)
    for row in range(1, shape[-2] - 1, 2):  # open corridors joined at alternating ends
        snake[row, 1:-1] = False
        if row + 2 < shape[-2] - 1:
            snake[row + 1, -2 if (row // 2) % 2 == 0 else 1] = False
    snake[1, 0] = False  # the corridor's only opening
    snake = snake if len(shape) == 2 else np.broadcast_to(snake, shape).copy()
    for m in (mask, snake, np.zeros(shape, bool), np.ones(shape, bool)):
        got = tm.binary_fill_holes(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, ndimage.binary_fill_holes(m))
        np.testing.assert_array_equal(got, np.asarray(jm.binary_fill_holes(jnp.asarray(m))))
    capped = tm.binary_fill_holes(torch.from_numpy(snake), max_iter=3).numpy()
    np.testing.assert_array_equal(
        capped, np.asarray(jm.binary_fill_holes(jnp.asarray(snake), max_iter=3)))
    assert capped.sum() > snake.sum()  # the cap stops the flood: unreached cells count as holes


@pytest.mark.parametrize("impl", ["auto", "device"])
def test_largest_component_2d_matches_jax(impl):
    rng = np.random.default_rng(15)
    mask = ndimage.binary_dilation(rng.random((30, 26)) > 0.9, iterations=1)
    empty = np.zeros((6, 7), bool)
    for m in (mask, empty):
        if impl == "auto":
            got = tcc.largest_component_2d(torch.from_numpy(m))
            want = jcc.largest_component_2d(jnp.asarray(m))
        else:
            got = tcc.largest_component(torch.from_numpy(m), impl="device")
            want = jcc.largest_component(jnp.asarray(m), impl="device")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lab, n = ndimage.label(mask)
    sizes = ndimage.sum(mask, lab, range(1, n + 1))
    assert tcc.largest_component_2d(torch.from_numpy(mask)).sum() == sizes.max()


# ------------------------------------------------------- coarse-to-fine

def test_sumpool_of_fine_splat_is_the_coarse_splat():
    """Exactly, on the counts and on integer-valued planes (their fp32 sums
    are exact in any order); fp32 planes to rtol 1e-6, as the JAX test."""
    rng = np.random.default_rng(10)
    shape, ss, sl = (21, 17, 13), 4, 8
    luma = torch.from_numpy((rng.random(shape) * 255.0).astype(np.float32))[None]
    ints = torch.from_numpy(rng.integers(0, 8, shape).astype(np.float32))[None]
    vals = torch.from_numpy(rng.random(shape, np.float32))[None]
    for t, c, rtol in ((ints, ints, 0), (vals, vals, 1e-6)):
        fine = tb.bls_splat_plain(luma, t, c, ss, sl)
        coarse = tb.bls_splat_plain(luma, t, c, 2 * ss, 2 * sl)
        ext_f, ext_c = (tb._grid_extents(shape, k * ss, k * sl) for k in (1, 2))
        pooled = tb._sumpool2(fine.reshape((3,) + ext_f), ext_c)
        torch.testing.assert_close(pooled, coarse.reshape((3,) + ext_c), rtol=rtol, atol=0)
    jfine = jnp.asarray(fine.reshape((3,) + ext_f).numpy())
    np.testing.assert_array_equal(pooled[1].numpy(), np.asarray(jb._sumpool2(jfine[1], ext_c)))
    yc = rng.standard_normal(ext_c).astype(np.float32)
    np.testing.assert_array_equal(tb._prolong2(torch.from_numpy(yc[None]), ext_f)[0].numpy(),
                                  np.asarray(jb._prolong2(jnp.asarray(yc), ext_f)))


def _structured_case(S=24, seed=11):
    rng = np.random.RandomState(seed)
    z, y, x = np.mgrid[:S, :S, :S]
    blob = (z - S // 2) ** 2 + (y - S // 2) ** 2 + (x - S // 2) ** 2 < (0.3 * S) ** 2
    luma = np.clip(np.where(blob, 180.0, 80.0) + 12 * rng.randn(S, S, S), 0, 255)
    t = np.clip(blob + 0.2 * rng.randn(S, S, S), 0, 1).astype(np.float32)
    return t, luma.astype(np.float32), np.full((S, S, S), 0.9, np.float32)


@pytest.mark.parametrize("pixel_impl", ["auto", "reblock"])
def test_coarse_to_fine_matches_jax(pixel_impl):
    arrs = _structured_case()
    kw = dict(sigma_spatial=7, sigma_luma=5, coarse_to_fine=True)
    want = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, arrs), pixel_impl="scan", **kw))
    got = tb.bilateral_solve_gray(*map(torch.from_numpy, arrs), pixel_impl=pixel_impl, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    want5 = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, arrs), pixel_impl="scan",
                                               fine_maxiter=3, **kw))
    got5 = tb.bilateral_solve_gray(*map(torch.from_numpy, arrs), pixel_impl=pixel_impl,
                                   fine_maxiter=3, **kw)
    np.testing.assert_allclose(got5.numpy(), want5, rtol=2e-4, atol=2e-4)
    assert not np.array_equal(got5.numpy(), got.numpy())


def test_coarse_to_fine_bounded_deviation():
    """tests/test_bilateral.py's bound, at its size: the two solves differ by
    CG convergence only, and thresholded masks agree."""
    args = [torch.from_numpy(a) for a in _structured_case(S=40)]
    kw = dict(sigma_spatial=7, sigma_luma=5)
    exact = tb.bilateral_solve_gray(*args, **kw).numpy()
    c2f = tb.bilateral_solve_gray(*args, coarse_to_fine=True, **kw).numpy()
    d = np.abs(exact - c2f)
    assert d.max() < 0.05 and d.mean() < 0.002
    m_e, m_c = exact > 0.5, c2f > 0.5
    assert m_e.sum() > 1000
    assert (m_e == m_c).mean() > 0.999
    assert (m_e & m_c).sum() / max((m_e | m_c).sum(), 1) > 0.99


def _adversarial(name):
    rng = np.random.default_rng(16)
    shape, sl = (16, 15, 14), 8
    z = np.mgrid[:16, :15, :14][0]
    t = (z > 7).astype(np.float32)
    luma = {
        "constant": np.full(shape, 100.0),
        "one_bin": 96.0 + 7.9 * rng.random(shape),  # all in bin 12
        # a step exactly on a bin edge, and the values just below it
        "knife_edge": np.where(z > 7, 128.0, np.nextafter(np.float32(128.0), np.float32(0))),
        "alternating": np.where((z % 2) == 0, 0.0, 255.0),  # bins 0 and L − 1
    }[name].astype(np.float32)
    return t, luma, np.full(shape, 0.9, np.float32), sl


@pytest.mark.parametrize("name", ["constant", "one_bin", "knife_edge", "alternating"])
def test_coarse_to_fine_adversarial_lumas_match_jax(name):
    t, luma, c, sl = _adversarial(name)
    kw = dict(sigma_spatial=4, sigma_luma=sl, coarse_to_fine=True)
    want = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, (t, luma, c)),
                                              pixel_impl="scan", **kw))
    for impl in ("auto", "reblock"):
        got = tb.bilateral_solve_gray(*map(torch.from_numpy, (t, luma, c)), pixel_impl=impl, **kw)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_coarse_to_fine_guard_takes_the_direct_solve():
    """A lattice axis of extent 1 (3 slices at σ_s 4): the two-level solve
    needs every extent ≥ 2, so the direct solve runs, bit for bit; the guard
    reads the true-rank lattice, so a 2-D solve with two cells per axis does
    take two levels."""
    rng = np.random.default_rng(17)
    shape = (3, 13, 11)
    arrs = [torch.from_numpy(a) for a in (rng.random(shape, np.float32),
                                          (rng.random(shape) * 255).astype(np.float32),
                                          rng.random(shape, np.float32))]
    kw = dict(sigma_spatial=4, sigma_luma=8)
    direct = tb.bilateral_solve_gray(*arrs, **kw)
    assert torch.equal(tb.bilateral_solve_gray(*arrs, coarse_to_fine=True, **kw), direct)
    want = np.asarray(jb.bilateral_solve_gray(*(jnp.asarray(a.numpy()) for a in arrs),
                                              pixel_impl="scan", coarse_to_fine=True, **kw))
    np.testing.assert_allclose(direct.numpy(), want, rtol=2e-4, atol=2e-4)
    flat = [a[1] for a in arrs]
    kw2 = dict(sigma_spatial=8, sigma_luma=8, blur_dim=5)
    two = tb.bilateral_solve_gray(*flat, coarse_to_fine=True, fine_maxiter=1, **kw2)
    assert not torch.equal(two, tb.bilateral_solve_gray(*flat, **kw2))
    want2 = np.asarray(jb.bilateral_solve_gray(*(jnp.asarray(a.numpy()) for a in flat),
                                               pixel_impl="scan", coarse_to_fine=True,
                                               fine_maxiter=1, **kw2))
    np.testing.assert_allclose(two.numpy(), want2, rtol=2e-4, atol=2e-4)


def _ordered_blocked_splat_model(il_b, c_b, tc_b, L, groups):
    """The order the card's blocked splat (K7a) promises, in numpy: every
    (cell, bin) is the fp32 sum of the cell's slots taken one after the other
    in ascending slot index (rows of the cell, then lanes)."""
    n_rows, pb = il_b.shape
    n_cells = n_rows // groups
    out = np.zeros((3, n_cells, L), np.float32)
    for row in range(n_rows):
        for p in range(pb):
            b = il_b[row, p]
            if 0 <= b < L:
                cell = row // groups
                out[0, cell, b] = np.float32(out[0, cell, b] + np.float32(1))
                out[1, cell, b] = np.float32(out[1, cell, b] + c_b[row, p])
                out[2, cell, b] = np.float32(out[2, cell, b] + tc_b[row, p])
    return out


@pytest.mark.parametrize("shape,ss", [((17, 12, 20), 4), ((5, 9, 7), 7)])
def test_blocked_splat_plain_on_cpu_sums_in_ascending_slot_order(shape, ss):
    """``bls_splat_blocked_plain`` on CPU tensors equals the order-fixed model
    bit for bit: the yardstick the card's kernel is held to exactly."""
    sl = 8
    L = tb._grid_extents(shape, ss, sl)[-1]
    luma, t, c = _planes(shape, 5)
    bins = torch.from_numpy((luma / np.float32(sl)).astype(np.int32)[None])
    il_b = tb.bls_reblock(bins, ss, -1)
    c_b = tb.bls_reblock(torch.from_numpy(c[None]), ss)
    tc_b = tb.bls_reblock(torch.from_numpy((t * c)[None]), ss)
    got = tb.bls_splat_blocked_plain(il_b, c_b, tc_b, L, ss)[0].numpy()
    want = _ordered_blocked_splat_model(il_b[0].numpy(), c_b[0].numpy(), tc_b[0].numpy(), L, ss)
    np.testing.assert_array_equal(got, want)


def test_blocked_splat_twin_matches_pallas_interpret_on_a_ragged_crop():
    """The 61 x 47 x 53 crop of the card's check at the refinement's grid
    (sigma 7 / 5), through the K6 layout."""
    shape, ss, sl = (61, 47, 53), 7, 5
    ext = jb._grid_extents(shape, ss, sl)
    L = ext[-1]
    _, (il_b, c_b, tc_b) = _blocked_inputs(shape, ss, sl, 6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jb._splat_pallas(*map(jnp.asarray, (il_b, c_b, tc_b)), L, groups=ss))
    got = tb.bls_splat_blocked(*(torch.from_numpy(a[None]) for a in (il_b, c_b, tc_b)), L, ss)
    np.testing.assert_array_equal(got[0, 0].numpy(), want[0])
    assert got[0, 0].sum() == np.prod(shape)
    np.testing.assert_allclose(got[0, 1:].numpy(), want[1:], rtol=1e-5, atol=1e-5)
