"""K12, the bilateral solver's lattice-side solve in one launch
(``ops/bilateral.py::lattice_solve`` → ``csrc/lattice_solve.cu``).

On the CPU: the wrapper's refusals, raised before any launch; K12's plan,
as plain Python (every vertex of every class owned by one block, the halo
a block reads from device memory, resident or streamed by the lattice's
shape); its counter among the graph cache's wrappers, so that a replay adds
its capture's launch once; and the CPU route, which is the per-op twin
``_lattice_solve`` around ``bls_blur`` itself (tests/test_torch_bilateral_graph.py
holds it against the JAX solve).

The ``card`` test needs a CUDA card (it skips without one; run it with
``python -m pytest --noconftest -m card tests/test_torch_lattice_solve.py``,
the package's conftest imports JAX): a refined edit of the benchmark's
refined cell, replayed from the refine core's graph, launches K12 once and
K8 never. ``chip_smoke.py::phase_lattice_solve`` holds K12's answers.
"""
import itertools
import math

import numpy as np
import pytest
import torch

from vittf_tpu_torch.ops import bilateral as tb
from vittf_tpu_torch.utils import cuda_graphs as cg

KW = dict(lam=256.0, A_diag_min=1e-5, cg_tol=1e-5, cg_maxiter=25, bistoch_iters=10, blur_dim=6)
SEED = 20231


def splat_planes(B, ext, seed=SEED):
    """(m, w, b) as a splat gives them: the unbound planes of (B, 3, nverts),
    counts with empty vertices, Σc and Σt·c."""
    rng = np.random.default_rng(seed)
    n = math.prod(ext)
    m = rng.integers(0, 4, (B, n)).astype(np.float32)
    w = m * rng.uniform(0.2, 1.0, (B, n)).astype(np.float32)
    b = w * rng.uniform(0.0, 1.0, (B, n)).astype(np.float32)
    return torch.from_numpy(np.stack([m, w, b], axis=1)).unbind(1)


# ---- the wrapper's refusals

REFUSALS = {
    "fp64 planes": "fp32",
    "planes of another shape": "is not",
    "one lattice axis": "2-4 lattice axes",
    "five lattice axes": "2-4 lattice axes",
    "rows of stride 2": "unit stride",
    "planes at two class strides": "one class stride",
    "a y0 of another shape": "is not",
    "a y0 not contiguous": "contiguous y0",
    "a y0 in fp64": "fp32",
}


def refused_inputs(case):
    """(m, w, b, ext, y0) on the CPU, right but for ``case``."""
    ext = (3, 4, 5, 8)
    m, w, b = splat_planes(2, ext)
    y0 = None
    if case == "fp64 planes":
        m, w, b = (t.double() for t in (m, w, b))
    elif case == "planes of another shape":
        b = b[:, :-1]
    elif case == "one lattice axis":
        ext = (math.prod(ext),)
    elif case == "five lattice axes":
        ext = (1,) + ext
    elif case == "rows of stride 2":
        m, w, b = (torch.stack([t, t], dim=2).reshape(2, -1)[:, ::2] for t in (m, w, b))
    elif case == "planes at two class strides":
        m = m.contiguous()
    elif case == "a y0 of another shape":
        y0 = torch.zeros(1, math.prod(ext))
    elif case == "a y0 not contiguous":
        y0 = torch.zeros(math.prod(ext), 2).t()
    elif case == "a y0 in fp64":
        y0 = torch.zeros(2, math.prod(ext), dtype=torch.float64)
    return m, w, b, ext, y0


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_wrapper_refuses_before_a_launch(case):
    m, w, b, ext, y0 = refused_inputs(case)
    before = tb.lattice_solve.launches
    with pytest.raises(ValueError, match=REFUSALS[case]):
        tb._solve_launch(m, w, b, ext, **KW, y0=y0)
    assert tb.lattice_solve.launches == before


def test_the_unbound_planes_of_a_splat_are_taken():
    """The solve's own inputs, ``splat3.reshape(B, 3, -1).unbind(1)``, pass
    the checks as they are: no copy before the launch."""
    m, w, b = splat_planes(3, (2, 3, 4, 8))
    assert m.stride() == (3 * 192, 1) and not m.is_contiguous()
    assert tb._check_solve_inputs(m, w, b, (2, 3, 4, 8), None) == (2, 3, 4, 8)
    assert tb._check_solve_inputs(m, w, b, (6, 4, 8), torch.zeros(3, 192)) == (1, 6, 4, 8)


def test_a_device_without_the_kernel_is_refused():
    m, w, b = (t.to("meta") for t in splat_planes(1, (2, 2, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        tb.lattice_solve(m, w, b, (2, 2, 8), **KW)


# ---- the plan

PLAN_CASES = [(1, 19 * 19 * 19 * 52, 132), (4, 37**3 * 52, 132), (1, 86 * 86 * 64, 132),
              (5, 19**3 * 52, 132), (2, 1000, 132), (300, 1000, 132), (7, 5, 8), (1, 31, 4),
              (3, 40000, 16)]


@pytest.mark.parametrize("B,nverts,n_sms", PLAN_CASES)
def test_the_plan_owns_every_vertex_once(B, nverts, n_sms):
    """Launches take consecutive classes, each at most ``n_sms`` blocks; a
    class's segments, 32-vertex aligned and none empty, cover its vertices
    once."""
    plans = tb._solve_plan(B, nverts, n_sms)
    assert [p.c0 for p in plans] == [0] + [p.c1 for p in plans[:-1]] and plans[-1].c1 == B
    for p in plans:
        assert 1 <= p.blocks <= n_sms and p.seg % 32 == 0
        owned = np.zeros(nverts, np.int64)
        for s in range(p.segments):
            lo, hi = s * p.seg, min(nverts, (s + 1) * p.seg)
            assert lo < hi
            owned[lo:hi] += 1
        assert (owned == 1).all()
    # one launch whenever the classes fit the card, as in every call the port makes
    assert len(plans) == -(-B // n_sms)


def stencil_words(ext, i):
    """The words of a class's lattice that vertex i's blur reads."""
    at = np.unravel_index(i, ext)
    words = {i}
    for ax, e in enumerate(ext):
        for step in (-1, 1):
            if 0 <= at[ax] + step < e:
                nb = list(at)
                nb[ax] += step
                words.add(int(np.ravel_multi_index(nb, ext)))
    return words


@pytest.mark.parametrize("ext,n_sms", [((5, 4, 3, 8), 7), ((6, 7, 9), 5), ((11, 13), 3),
                                       ((3, 3, 3, 52), 4)])
def test_a_segments_halo_is_one_step_of_the_leading_axis(ext, n_sms):
    """Every word a segment's stencils read lies in its own class's lattice,
    within one step of the leading lattice axis of the segment; the words
    outside the segment (its halo, read from device memory) exist for
    every segment but a lone one, on both sides of an inner segment."""
    nverts, sz = math.prod(ext), math.prod(ext[1:])
    (plan,) = tb._solve_plan(1, nverts, n_sms)
    assert plan.segments > 1
    for s in range(plan.segments):
        lo, hi = s * plan.seg, min(nverts, (s + 1) * plan.seg)
        read = set().union(*(stencil_words(ext, i) for i in range(lo, hi)))
        halo = {k for k in read if not lo <= k < hi}
        assert all(0 <= k < nverts for k in read)
        assert all(lo - sz <= k < hi + sz for k in halo)
        assert any(k < lo for k in halo) == (s > 0)
        assert any(k >= hi for k in halo) == (hi < nverts)


def test_resident_or_streamed_by_the_lattices_shape():
    """A block keeps its state in shared memory when its segment's 11
    vectors fit: the refined edit's lattice and the 2-D solver's on an
    H100's 132 SMs; the whole-grid chunk streams. The line lies at
    ``SOLVE_SHARED_BYTES``."""
    def plan(B, ext):
        (p,) = tb._solve_plan(B, math.prod(ext), 132)
        return p

    cell, whole, flat = plan(1, (19, 19, 19, 52)), plan(4, (37, 37, 37, 52)), plan(1, (86, 86, 64))
    assert (cell.resident, cell.segments, cell.seg) == (True, 132, 2720)
    assert (whole.resident, whole.segments) == (False, 33)
    assert flat.resident
    words = tb.SOLVE_SHARED_BYTES // (4 * tb.SOLVE_VECTORS["resident"]) // 32 * 32
    assert tb._solve_plan(1, 132 * words, 132)[0].resident
    assert not tb._solve_plan(1, 132 * words + 132 * 32, 132)[0].resident


# ---- the counter and the graph cache


def test_the_counter_is_among_the_graph_wrappers():
    assert tb.lattice_solve in tb._WRAPPERS and tb.lattice_solve.launches >= 0
    for impl, rank in itertools.product(("auto", "reblock"), (2, 3)):
        assert tb._pixel_ops(impl, rank)[1] is tb.lattice_solve
    plain = tb._pixel_ops("scatter", 3)[1]
    assert plain.func is tb._lattice_solve and plain.keywords == {"blur": tb._blur}


class _StubGraph:
    """A replay writes ``fn(*inputs)`` into the output, as the kernels would."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output

    def replay(self):
        self.output.copy_(self.fn(*self.inputs))


def test_a_replay_adds_its_captures_launch_once():
    """A captured solve counted one K12 launch and no blur: each replay
    adds that delta once, and no other counter moves."""
    before = {fn: fn.launches for fn in tb._WRAPPERS}

    def capture():
        tb.lattice_solve.launches += 1
        tb.bls_splat.launches += 1
        return "graph"

    _, counted = cg.uncounted(capture, tb._WRAPPERS)
    assert counted == {tb.lattice_solve: 1, tb.bls_splat: 1}
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before
    inputs = (torch.zeros(4),)
    entry = cg.Graph(_StubGraph(lambda x: x + 1, inputs, torch.empty(4)), inputs,
                     torch.empty(4), counted, 0)
    entry.output = entry.graph.output
    for k in range(1, 4):
        assert torch.equal(entry(torch.full((4,), float(k))), torch.full((4,), k + 1.0))
        assert tb.lattice_solve.launches == before[tb.lattice_solve] + k
        assert tb.bls_blur.launches == before[tb.bls_blur]
    for fn, n in before.items():
        fn.launches = n


# ---- the CPU route


@pytest.mark.parametrize("ext,blur_dim,with_y0", [((3, 4, 5, 52), 6, False),
                                                   ((3, 4, 5, 52), 6, True),
                                                   ((9, 7, 16), 5, False)])
def test_cpu_tensors_take_the_per_op_twin(ext, blur_dim, with_y0):
    """On CPU tensors ``lattice_solve`` is ``_lattice_solve`` around
    ``bls_blur``, bit for bit, and counts no launch."""
    m, w, b = splat_planes(2, ext)
    y0 = torch.rand(2, math.prod(ext), generator=torch.Generator().manual_seed(1)) \
        if with_y0 else None
    kw = {**KW, "blur_dim": blur_dim}
    before = {fn: fn.launches for fn in tb._WRAPPERS}
    got = tb.lattice_solve(m, w, b, ext, **kw, y0=y0)
    assert {fn: fn.launches for fn in tb._WRAPPERS} == before
    assert torch.equal(got, tb._lattice_solve(m, w, b, ext, **kw, blur=tb.bls_blur, y0=y0))
    assert torch.equal(got, tb._lattice_solve(m, w, b, ext, **kw, blur=tb._blur, y0=y0))
    assert bool(torch.isfinite(got).all())


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_a_refined_edit_replays_one_lattice_solve_and_no_blur(card):
    """The refined cell's session, warmed as the benchmark warms it, then
    one edit: its refine core is a replay, which launches K12 once and K8
    never (the per-op solve launched K8 37 times)."""
    from portbench.harness import edit, spec
    from vittf_tpu_torch.pipeline.session import InteractiveSession

    cell = spec.load_cell("vits8-edit-refined-256")
    tr = cell.traffic
    vol, feats, painter = edit.make_inputs(cell, SEED, card)
    session = InteractiveSession(
        vol.cpu().numpy(), feats, bilateral_solver=True, bls_shape_bucket=tr["bls_shape_bucket"],
        dirty_tracking=True, device=card)

    def serve():
        session.update_annotations(painter.state)
        return session.predict().cpu()

    serve()
    for _ in range(int(tr["warm_rounds"]) * len(painter.names)):
        painter.edit()
        serve()
    seen = []
    before = (tb.lattice_solve.launches, tb.bls_blur.launches, cg.GRAPHS.hits)
    for _ in range(len(painter.names)):  # one edit of every class: each a refine core
        painter.edit()
        serve()
        torch.cuda.synchronize()
        now = (tb.lattice_solve.launches, tb.bls_blur.launches, cg.GRAPHS.hits)
        seen.append(tuple(a - b for a, b in zip(now, before)))
        before = now
    # (K12 launches, K8 launches, graph replays) of each edit
    assert seen == [(1, 0, 1)] * len(painter.names)
