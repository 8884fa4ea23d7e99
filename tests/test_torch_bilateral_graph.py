"""The captured bilateral solve of vittf_tpu_torch.ops.bilateral, on the CPU.

On CUDA tensors in a kernel form ``bilateral_solve_gray_batched`` replays
one CUDA graph per key (``_graph_key``: device, (B, *spatial), form and the
JAX twin's static arguments); ``chip_smoke.py`` holds every graphed solve
on the card against the eager body (``torch.equal``), first call and
replay. Here: the key, the cache's bound, the launch bookkeeping on stub
entries, and the CPU route, which is the eager body itself and matches the
JAX solve at the tolerance of tests/test_torch_bilateral.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vittf_tpu.ops import bilateral as jb
from vittf_tpu_torch.ops import bilateral as tb

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
    lookups = (tb._GRAPHS.hits, tb._GRAPHS.misses)
    got = tb.bilateral_solve_gray_batched(*args, **kw)
    assert (tb._GRAPHS.hits, tb._GRAPHS.misses) == lookups
    assert torch.equal(got, tb._bilateral_solve_eager(*args, **_solve_kw(**kw)))
    want = np.asarray(jb.bilateral_solve_gray(*map(jnp.asarray, (t, luma, c)),
                                              pixel_impl="scan", **kw))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-4, atol=2e-4)


def test_graphed_solve_refuses_inputs_the_kernels_refuse():
    """The static buffers take any input copy_ broadcasts; the eager kernels
    do not, so the graph route refuses them before it captures."""
    t = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="differ in shape"):
        tb._graphed_solve(t, t, torch.zeros(2, 1, 8), _solve_kw())
    with pytest.raises(ValueError, match="differ in shape"):
        tb._graphed_solve(t, torch.zeros(8, 8), t, _solve_kw())


def test_graph_cache_evicts_the_entry_used_least_recently():
    cache = tb._GraphCache(bound=2)
    made = []

    def make(name):
        def f():
            made.append(name)
            return name
        return f

    assert cache.get("a", make("a")) == "a"
    assert cache.get("b", make("b")) == "b"
    assert cache.get("a", make("a2")) == "a"  # a hit: made nothing, "a" is now the newest
    assert cache.get("c", make("c")) == "c"  # evicts "b"
    assert list(cache.entries) == ["a", "c"]
    assert cache.get("b", make("b2")) == "b2"  # "b" was gone: made again, evicts "a"
    assert list(cache.entries) == ["c", "b"]
    assert made == ["a", "b", "c", "b2"]
    assert (cache.hits, cache.misses) == (1, 4)
    cache.clear()
    assert not cache.entries and cache.get("d", make("d")) == "d"


def test_graph_cache_keeps_no_entry_when_making_it_fails():
    cache = tb._GraphCache(bound=1)
    cache.get("a", lambda: "a")

    def fail():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get("b", fail)
    assert not cache.entries


class _StubGraph:
    """Stands in for a CUDAGraph: a replay writes target + luma · confidence
    into the output buffer, as a captured kernel would."""

    def __init__(self, inputs, output):
        self.inputs, self.output, self.replays = inputs, output, 0

    def replay(self):
        t, lu, c = self.inputs
        self.output.copy_(t + lu * c)
        self.replays += 1


def test_replay_adds_the_capture_deltas_once_per_call():
    inputs = tuple(torch.zeros(2, 3, 4) for _ in range(3))
    output = torch.empty(2, 3, 4)
    graph = _StubGraph(inputs, output)
    entry = tb._SolveGraph(graph, inputs, output, {tb.bls_blur: 37, tb.bls_splat: 1})
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

    out, counted = tb._uncounted(capture)
    assert out == "graph" and counted == {tb.bls_blur: 37, tb.bls_splat_blocked: 1}
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before

    def fails():
        tb.bls_slice.launches += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError):
        tb._uncounted(fails)
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before
