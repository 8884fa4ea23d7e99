"""The graph cache (vittf_tpu_torch.utils.cuda_graphs) and the captured
bilateral solve of vittf_tpu_torch.ops.bilateral, on the CPU.

On CUDA tensors in a kernel form ``bilateral_solve_gray_batched`` goes
through the graph cache, one CUDA graph per key (``_graph_key``: device,
(B, *spatial), form and the JAX twin's static arguments): eager on the
key's first sighting, captured on the second, replayed after, within a
count bound and a byte budget; ``chip_smoke.py`` holds every graphed solve
on the card against the eager body (``torch.equal``), capture and replay.
Here: the key, the sighting policy, the bounds, the launch bookkeeping on
stub entries, and the CPU route, which is the eager body itself and matches
the JAX solve at the tolerance of tests/test_torch_bilateral.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import bilateral as jb
from vittf_tpu_torch.ops import bilateral as tb
from vittf_tpu_torch.utils import cuda_graphs as cg

CUDA0 = torch.device("cuda", 0)


def _solve_kw(**over):
    kw = dict(sigma_spatial=24, sigma_luma=4, lam=256.0, A_diag_min=1e-5, cg_tol=1e-5,
              cg_maxiter=25, bistoch_iters=10, blur_dim=6, pixel_impl="auto",
              coarse_to_fine=False, fine_maxiter=10)
    return {**kw, **over}


def test_graph_key_is_equal_for_equal_arguments():
    shape = (5, 40, 32, 24)
    assert tb._graph_key(CUDA0, shape, _solve_kw()) == tb._graph_key(
        torch.device("cuda", 0), torch.Size(shape), _solve_kw())
    # in 2-D 'auto' is the split form: one graph for both names
    flat = (1, 64, 48)
    assert tb._graph_key(CUDA0, flat, _solve_kw(pixel_impl="auto")) == tb._graph_key(
        CUDA0, flat, _solve_kw(pixel_impl="reblock"))
    assert tb._graph_key(CUDA0, shape, _solve_kw())[:3] == (0, shape, "fused")


@pytest.mark.parametrize("change", [
    ("sigma_spatial", 7), ("sigma_luma", 5), ("lam", 128.0), ("A_diag_min", 1e-4),
    ("cg_tol", 1e-6), ("cg_maxiter", 26), ("bistoch_iters", 9), ("blur_dim", 5),
    ("pixel_impl", "reblock"), ("coarse_to_fine", True), ("fine_maxiter", 25),
    ("B", None), ("shape", None), ("device", None),
])
def test_graph_key_differs_for_each_static_argument(change):
    """One case per name in the JAX twin's ``static_argnames`` (pixel_impl
    as its form), and B, the spatial shape and the device."""
    name, value = change
    device, shape, kw = CUDA0, (5, 40, 32, 24), _solve_kw()
    base = tb._graph_key(device, shape, kw)
    if name == "B":
        shape = (4,) + shape[1:]
    elif name == "shape":
        shape = shape[:-1] + (32,)
    elif name == "device":
        device = torch.device("cuda", 1)
    else:
        kw[name] = value
    assert tb._graph_key(device, shape, kw) != base


def _structured_case(S, seed):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[:S, :S, :S]
    blob = (z - S // 2) ** 2 + (y - S // 2) ** 2 + (x - S // 2) ** 2 < (0.3 * S) ** 2
    luma = np.clip(np.where(blob, 180.0, 80.0) + 12 * rng.standard_normal((S,) * 3), 0, 255)
    t = np.clip(blob + 0.2 * rng.standard_normal((S,) * 3), 0, 1).astype(np.float32)
    c = (0.4 + 0.5 * rng.random((S,) * 3)).astype(np.float32)
    return t, luma.astype(np.float32), c


@pytest.mark.parametrize("rank", [3, 2])
@pytest.mark.parametrize("coarse_to_fine", [False, True])
def test_cpu_route_is_the_eager_body_and_matches_jax(rank, coarse_to_fine):
    """CPU tensors take the eager body, bit for bit, and touch no graph; the
    answer is the JAX solve's at 2e-4 (tests/test_torch_bilateral.py)."""
    t, luma, c = _structured_case(18, 4)
    if rank == 2:
        t, luma, c = (a[9] for a in (t, luma, c))
        kw = dict(sigma_spatial=4, sigma_luma=5, blur_dim=jb._BLUR_DIM_2D)
    else:
        kw = dict(sigma_spatial=4, sigma_luma=5)
    kw["coarse_to_fine"] = coarse_to_fine
    args = [torch.from_numpy(a)[None] for a in (t, luma, c)]
    lookups = (cg.GRAPHS.hits, cg.GRAPHS.misses, cg.GRAPHS.eager)
    got = tb.bilateral_solve_gray_batched(*args, **kw)
    assert (cg.GRAPHS.hits, cg.GRAPHS.misses, cg.GRAPHS.eager) == lookups
    assert torch.equal(got, tb._bilateral_solve_eager(*args, **_solve_kw(**kw)))
    want = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, (t, luma, c)),
                                              pixel_impl="scan", **kw))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rank,with_y0", [(3, False), (3, True), (2, False)])
def test_cpu_lattice_solve_is_the_per_op_twin_and_matches_jax(rank, with_y0):
    """K12's wrapper on CPU tensors is the per-op ``_lattice_solve`` around
    the plain blur, bit for bit, counting no launch; per class it is the
    JAX ``_lattice_solve`` at the solve's 2e-4 (a structured splat, with
    and without the coarse-to-fine start)."""
    t, luma, c = _structured_case(18, 5)
    if rank == 2:
        t, luma, c = (a[9] for a in (t, luma, c))
    ss, sl, dim = 4, 5, (jb._BLUR_DIM if rank == 3 else jb._BLUR_DIM_2D)
    ext = tb._grid_extents(t.shape, ss, sl)
    planes = tb.bls_splat_plain(*(torch.from_numpy(np.stack([a, a[::-1].copy()]))
                                  for a in (luma, t, c)), ss, sl)
    m, w, b = planes.reshape(2, 3, -1).unbind(1)
    y0 = torch.where(m > 0, b / w.clamp(min=1e-3), 0.0) if with_y0 else None
    kw = dict(lam=256.0, A_diag_min=1e-5, cg_tol=1e-5, cg_maxiter=25, bistoch_iters=10,
              blur_dim=dim)
    before = tb.lattice_solve.launches
    got = tb.lattice_solve(m, w, b, ext, **kw, y0=y0)
    assert tb.lattice_solve.launches == before
    assert torch.equal(got, tb._lattice_solve(m, w, b, ext, **kw, blur=tb._blur, y0=y0))
    for k in range(2):
        want = jb._lattice_solve(*(jnp.asarray(v[k].numpy()) for v in (m, w, b)), ext, **kw,
                                 y0=None if y0 is None else jnp.asarray(y0[k].numpy()))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_graphed_solve_refuses_inputs_the_kernels_refuse():
    """The static buffers take any input copy_ broadcasts; the eager kernels
    do not, so the graph route refuses them before it captures."""
    t = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="differ in shape"):
        tb._graphed_solve(t, t, torch.zeros(2, 1, 8), _solve_kw())
    with pytest.raises(ValueError, match="differ in shape"):
        tb._graphed_solve(t, torch.zeros(8, 8), t, _solve_kw())


class _StubGraph:
    """Stands in for a CUDAGraph: a replay writes ``fn(*inputs)`` into the
    output buffer, as the captured kernels would."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output, self.replays = fn, inputs, output, 0

    def replay(self):
        self.output.copy_(self.fn(*self.inputs))
        self.replays += 1


def _stub_make(made, nbytes=1, launches=None):
    """``make`` for ``GraphCache.call``: a stub graph of ``fn`` = sum of the
    arguments, ``nbytes`` bytes; records each capture's arguments."""
    def make(*args):
        made.append(args)
        inputs = tuple(x.clone() for x in args)
        output = torch.empty_like(args[0])
        graph = _StubGraph(lambda *a: sum(a), inputs, output)
        return cg.Graph(graph, inputs, output, launches or {}, nbytes)
    return make


def _eager(*args):
    return sum(args)


def test_first_sighting_runs_eager_and_the_second_captures():
    cache, made = cg.GraphCache(bound=4, budget=100), []
    x, y, z = (torch.full((3,), v) for v in (1.0, 2.0, 5.0))
    got = cache.call("k", (x, y), _eager, _stub_make(made), 100)
    assert torch.equal(got, x + y) and not made and not cache.entries
    assert list(cache.sightings) == ["k"] and (cache.hits, cache.misses, cache.eager) == (0, 0, 1)
    got = cache.call("k", (y, z), _eager, _stub_make(made), 100)  # captures, then replays
    assert torch.equal(got, y + z) and len(made) == 1 and list(cache.entries) == ["k"]
    assert not cache.sightings and (cache.hits, cache.misses, cache.eager) == (0, 1, 1)
    got = cache.call("k", (z, x), _eager, _stub_make(made), 100)  # a replay on other inputs
    assert torch.equal(got, z + x) and len(made) == 1
    assert cache.entries["k"].graph.replays == 2 and (cache.hits, cache.misses) == (1, 1)


def test_sightings_are_bounded_and_least_recently_seen_go_first():
    cache, made = cg.GraphCache(bound=4, budget=100, sighting_bound=2), []
    x = (torch.ones(2),)
    for key in ("a", "b", "c"):  # "a" is forgotten when "c" is seen
        cache.call(key, x, _eager, _stub_make(made), 100)
    assert list(cache.sightings) == ["b", "c"]
    cache.call("a", x, _eager, _stub_make(made), 100)  # a first sighting again: eager
    assert not made and list(cache.sightings) == ["c", "a"] and cache.eager == 4
    cache.call("c", x, _eager, _stub_make(made), 100)  # its second sighting: captured
    assert len(made) == 1 and list(cache.entries) == ["c"] and list(cache.sightings) == ["a"]


def _captured(cache, key, made, nbytes, x=(torch.ones(2),)):
    """Two calls of ``key``: an eager sighting, then a capture of ``nbytes``."""
    for _ in range(2):
        cache.call(key, x, _eager, _stub_make(made, nbytes), cache.budget)


def test_graph_cache_evicts_the_entry_used_least_recently():
    cache, made = cg.GraphCache(bound=2, budget=100), []
    _captured(cache, "a", made, 1)
    _captured(cache, "b", made, 1)
    cache.call("a", (torch.ones(2),), _eager, _stub_make(made), 100)  # a hit: "a" is newest
    _captured(cache, "c", made, 1)  # evicts "b"
    assert list(cache.entries) == ["a", "c"]
    _captured(cache, "b", made, 1)  # "b" was gone: seen, captured again, evicts "a"
    assert list(cache.entries) == ["c", "b"]
    assert len(made) == 4 and (cache.hits, cache.misses, cache.eager) == (1, 4, 4)
    cache.clear()
    assert not cache.entries and not cache.sightings


def test_graph_cache_evicts_until_its_bytes_fit_the_budget():
    cache, made = cg.GraphCache(bound=8, budget=100), []
    for key, nbytes in (("a", 40), ("b", 30), ("c", 20)):
        _captured(cache, key, made, nbytes)
    assert list(cache.entries) == ["a", "b", "c"] and cache.nbytes == 90
    cache.call("a", (torch.ones(2),), _eager, _stub_make(made), 100)  # "b" is now the oldest
    _captured(cache, "d", made, 50)  # 140 bytes: "b" goes, then "c"
    assert list(cache.entries) == ["a", "d"] and cache.nbytes == 90
    _captured(cache, "e", made, 100)  # alone at the budget: every other entry goes
    assert list(cache.entries) == ["e"] and cache.nbytes == 100


def test_a_capture_over_the_budget_is_replayed_once_then_runs_eager():
    cache, made = cg.GraphCache(bound=8, budget=100), []
    _captured(cache, "small", made, 60)
    x, y = torch.full((2,), 3.0), torch.full((2,), 4.0)
    cache.call("big", (x,), _eager, _stub_make(made, 101), 100)  # eager sighting
    got = cache.call("big", (x, y), _eager, _stub_make(made, 101), 100)
    assert torch.equal(got, x + y) and len(made) == 2  # captured and replayed once
    assert list(cache.entries) == ["small"] and cache.sightings["big"] == cg._EAGER_ONLY
    for _ in range(3):  # from then on eager, no capture
        assert torch.equal(cache.call("big", (y, y), _eager, _stub_make(made, 101), 100), y + y)
    assert len(made) == 2 and (cache.misses, cache.eager) == (2, 5)
    assert list(cache.entries) == ["small"]


def test_graph_cache_keeps_no_entry_when_making_it_fails():
    cache, made = cg.GraphCache(bound=1, budget=100), []
    _captured(cache, "a", made, 1)

    def fail(*args):
        raise RuntimeError("capture failed")

    x = (torch.ones(2),)
    cache.call("b", x, _eager, fail, 100)  # first sighting: eager, nothing made
    with pytest.raises(RuntimeError, match="capture failed"):
        cache.call("b", x, _eager, fail, 100)
    assert not cache.entries


def test_graphed_wires_the_body_and_its_capture(monkeypatch):
    """``graphed`` on CPU tensors with the capture stubbed: the body runs
    eager first, the capture gets the body and the counted wrappers."""
    calls, made = [], []

    def capture(body, args, wrappers):
        calls.append((body, wrappers))
        return _stub_make(made)(*args)

    monkeypatch.setattr(cg, "capture", capture)
    cache = cg.GraphCache(bound=2, budget=100)
    x, y = torch.ones(3), torch.full((3,), 2.0)
    for a, b in ((x, y), (y, y), (x, x)):
        assert torch.equal(cg.graphed("k", (a, b), _eager, tb._WRAPPERS, cache), a + b)
    assert calls == [(_eager, tb._WRAPPERS)]
    assert (cache.eager, cache.misses, cache.hits) == (1, 1, 1)


def test_replay_adds_the_capture_deltas_once_per_call():
    inputs = tuple(torch.zeros(2, 3, 4) for _ in range(3))
    output = torch.empty(2, 3, 4)
    graph = _StubGraph(lambda t, lu, c: t + lu * c, inputs, output)
    entry = cg.Graph(graph, inputs, output, {tb.bls_blur: 37, tb.bls_splat: 1}, 0)
    before = {fn: fn.launches for fn in tb._WRAPPERS}
    rng = np.random.default_rng(0)
    for k in range(1, 4):
        t, lu, c = (torch.from_numpy(rng.random((2, 3, 4))) for _ in range(3))  # float64
        got = entry(t, lu, c)
        assert graph.replays == k
        assert got.dtype == torch.float32 and got.data_ptr() != output.data_ptr()
        assert torch.equal(got, t.float() + lu.float() * c.float())
        assert tb.bls_blur.launches == before[tb.bls_blur] + 37 * k
        assert tb.bls_splat.launches == before[tb.bls_splat] + k
        assert all(fn.launches == before[fn] for fn in tb._WRAPPERS
                   if fn not in (tb.bls_blur, tb.bls_splat))
    kept = got.clone()
    entry(*(torch.ones(2, 3, 4) for _ in range(3)))
    assert torch.equal(got, kept)  # a returned answer outlives the next replay
    for fn, n in before.items():
        fn.launches = n


def test_uncounted_returns_the_deltas_and_restores_the_counters():
    before = {fn: fn.launches for fn in tb._WRAPPERS}

    def capture():
        tb.bls_blur.launches += 37
        tb.bls_splat_blocked.launches += 1
        return "graph"

    out, counted = cg.uncounted(capture, tb._WRAPPERS)
    assert out == "graph" and counted == {tb.bls_blur: 37, tb.bls_splat_blocked: 1}
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before

    def fails():
        tb.bls_slice.launches += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError):
        cg.uncounted(fails, tb._WRAPPERS)
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before
