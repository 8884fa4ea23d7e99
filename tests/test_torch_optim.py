"""Port parity: vittf_tpu_torch.train.optim against optax (0.2.6), the
library the JAX trainers take their optimizers from, on the CPU.

The schedules over whole runs (n ∈ {4, 10, 100, 1000}, every step and a few
past the end) at 1e-6 of their peak, NaN where optax is NaN (one-cycle at n ≤ 3); each
optimizer over 10 update steps from the same parameters and gradients at
1e-5: RAdam past its rectification threshold (ρ_t ≥ 5 from step 6), with
decayed weights chained in front, under a constant rate and both schedules;
SGD with momentum; LARS in optax's order; and the PAWS partition of LARS and
SGD under ``multi_transform``. The optimizer states are held where they have
a counterpart (RAdam's moments, the traces).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vittf_tpu_torch.train import optim

# relative to the schedule's peak: torch's fp32 cos and XLA's differ by ulps
# where cos(π·pct) + 1 is small, near a schedule's tail
SCHED = dict(rtol=1e-6, atol=1e-6 * 1e-3)
STEP = dict(rtol=1e-5, atol=1e-5)


def _values(fn, n, jax_side):
    counts = range(n + 3)
    if jax_side:
        return np.array([float(fn(jnp.asarray(c, jnp.int32))) for c in counts], np.float32)
    return np.array([float(fn(c)) for c in counts], np.float32)


@pytest.mark.parametrize("n", [4, 10, 100, 1000])
@pytest.mark.parametrize("kind", ["onecycle", "cosine"])
def test_schedules_match_optax(n, kind):
    if kind == "onecycle":
        want = _values(optax.cosine_onecycle_schedule(n, 1e-3), n, True)
        got = _values(optim.cosine_onecycle_schedule(n, 1e-3), n, False)
        # from peak / 25 to the peak at int(0.3·n), to peak / 25e4 at n
        np.testing.assert_allclose(got[[0, int(0.3 * n), n]], [4e-5, 1e-3, 4e-9], rtol=1e-4)
    else:
        want = _values(optax.cosine_decay_schedule(1e-3, n), n, True)
        got = _values(optim.cosine_decay_schedule(1e-3, n), n, False)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SCHED)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_onecycle_nan_below_four_steps_as_optax(n):
    """Copied as optax has it: a zero-width first interval gives 0/0 at
    every step (``make_optimizer`` guards it, ``make_paws_optimizer`` not)."""
    want = _values(optax.cosine_onecycle_schedule(n, 1e-3), n, True)
    got = _values(optim.cosine_onecycle_schedule(n, 1e-3), n, False)
    assert np.isnan(want).all() and np.isnan(got).all()


def _tree(rng):
    """A small parameter tree in the port's layout, with paths that the
    PAWS labels read: a conv weight and bias, a norm, a bn and a linear."""
    return {
        "encoder": {"convs": [{"conv": {"weight": rng.standard_normal((4, 2, 3, 3, 3)),
                                        "bias": rng.standard_normal(4)},
                               "norm": {"weight": 1 + 0.1 * rng.standard_normal(4),
                                        "bias": 0.1 * rng.standard_normal(4)}}]},
        "head": {"bn0": {"weight": 1 + 0.1 * rng.standard_normal(6),
                         "bias": 0.1 * rng.standard_normal(6)},
                 "fc1": {"weight": rng.standard_normal((3, 6)), "bias": rng.standard_normal(3)}},
    }


def _run(jopt, topt, tree, grads, labels_fn=None):
    """10 steps of both optimizers from ``tree`` on ``grads``; returns the
    (port, optax) parameters after each step, leaves in optax's order."""
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    leaves, treedef = jax.tree.flatten(jparams)
    tparams = [torch.from_numpy(np.array(a)) for a in leaves]
    jstate = jopt.init(jparams)
    tstate = topt.init(tparams)
    out = []
    for g in grads:
        jg = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g])
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = topt.update([torch.from_numpy(x) for x in g], tstate, tparams)
        optim.apply_updates(tparams, tupd)
        out.append(([p.numpy().copy() for p in tparams],
                    [np.asarray(p) for p in jax.tree.leaves(jparams)]))
    return out, tstate, jstate


def _grads(rng, tree, steps=10, scale=1.0):
    leaves = jax.tree.leaves(tree)
    return [[(scale * rng.standard_normal(np.shape(a))).astype(np.float32) for a in leaves]
            for _ in range(steps)]


def _assert_steps(out, tol=STEP):
    for got, want in out:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("schedule", ["const", "onecycle", "cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_ten_steps_match_optax(rng, schedule, weight_decay):
    tree = _tree(rng)
    lr = 1e-2
    if schedule == "onecycle":
        jlr, tlr = optax.cosine_onecycle_schedule(10, lr), optim.cosine_onecycle_schedule(10, lr)
    elif schedule == "cosine":
        jlr, tlr = optax.cosine_decay_schedule(lr, 10), optim.cosine_decay_schedule(lr, 10)
    else:
        jlr = tlr = lr
    jopt, topt = optax.radam(jlr), optim.radam(tlr)
    if weight_decay > 0:
        jopt = optax.chain(optax.add_decayed_weights(weight_decay), jopt)
        topt = optim.chain(optim.add_decayed_weights(weight_decay), topt)
    out, tstate, jstate = _run(jopt, topt, tree, _grads(rng, tree))
    _assert_steps(out)
    # the moments, where the rectified branch has run five times
    tr = tstate[-1][0] if weight_decay > 0 else tstate[0]
    jr = jstate[-1][0] if weight_decay > 0 else jstate[0]
    assert tr.count == int(jr.count) == 10
    for a, b in zip(tr.mu + tr.nu, jax.tree.leaves(jr.mu) + jax.tree.leaves(jr.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP)


def test_torch_classes_depart_from_optax(rng):
    """Why the port writes RAdam and the one-cycle schedule by hand.
    ``torch.optim.RAdam`` adds eps to √v before the bias correction, optax to
    √v̂: on gradients of 1e-6 its parameters leave optax's by more than 1e-5
    once the rectification starts (step 6), where the port's stay within
    1e-5 (what remains is the fp32 rounding of 1 − β₂ᵗ, whose ulps the
    rectification term amplifies). ``OneCycleLR`` peaks a step earlier and
    ends at peak / 25e4 itself, where optax ends at 5.07e-7 on 100 steps."""
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = [(1e-6 * rng.standard_normal(50)).astype(np.float32) for _ in range(10)]
    jp, js = jnp.asarray(p0), optax.radam(1e-2).init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_(True)
    cls = torch.optim.RAdam([tp], lr=1e-2)
    mine, mstate = [torch.from_numpy(p0.copy())], optim.radam(1e-2).init([torch.from_numpy(p0)])
    gap_cls, gap_mine = [], []
    for g in grads:
        u, js = optax.radam(1e-2).update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g)
        cls.step()
        u, mstate = optim.radam(1e-2).update([torch.from_numpy(g)], mstate, mine)
        optim.apply_updates(mine, u)
        gap_cls.append(np.abs(tp.detach().numpy() - np.asarray(jp)).max())
        gap_mine.append(np.abs(mine[0].numpy() - np.asarray(jp)).max())
    assert max(gap_mine) < 1e-5 < min(gap_cls[5:])

    p = torch.zeros(1, requires_grad=True)
    sgd = torch.optim.SGD([p], lr=1e-3)
    sched = torch.optim.lr_scheduler.OneCycleLR(sgd, max_lr=1e-3, total_steps=100,
                                                anneal_strategy="cos")
    lr_cls = []
    for _ in range(100):
        lr_cls.append(sgd.param_groups[0]["lr"])
        sgd.step()
        sched.step()
    want = _values(optax.cosine_onecycle_schedule(100, 1e-3), 100, True)
    got = _values(optim.cosine_onecycle_schedule(100, 1e-3), 100, False)
    assert np.argmax(lr_cls) == 29 and np.argmax(want) == np.argmax(got) == 30
    assert lr_cls[99] == pytest.approx(4e-9) and want[99] > 100 * lr_cls[99]


@pytest.mark.parametrize("schedule", ["const", "onecycle"])
def test_sgd_and_lars_ten_steps_match_optax(rng, schedule):
    tree = _tree(rng)
    lr = 0.1
    jlr, tlr = ((optax.cosine_onecycle_schedule(10, lr), optim.cosine_onecycle_schedule(10, lr))
                if schedule == "onecycle" else (lr, lr))
    out, tstate, jstate = _run(optax.sgd(jlr, momentum=0.9), optim.sgd(tlr, 0.9), tree,
                               _grads(rng, tree))
    _assert_steps(out)
    for a, b in zip(tstate[0], jax.tree.leaves(jstate[0].trace)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP)
    jl = optax.lars(jlr, weight_decay=1e-6, trust_coefficient=0.001, momentum=0.9)
    tl = optim.lars(tlr, weight_decay=1e-6, trust_coefficient=0.001, momentum=0.9)
    out, tstate, jstate = _run(jl, tl, tree, _grads(rng, tree))
    _assert_steps(out)
    # the momentum buffer holds lr-scaled updates (trace after the rate)
    for a, b in zip(tstate[-1], jax.tree.leaves(jstate[-1].trace)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP)


def test_trust_ratio_with_zero_norms():
    """A zero parameter or a zero update keeps the update as it is."""
    tr = optim.scale_by_trust_ratio(0.001)
    jt = optax.scale_by_trust_ratio(trust_coefficient=0.001)
    ps = [np.zeros(3, np.float32), np.ones(3, np.float32), np.full(3, 2.0, np.float32)]
    us = [np.ones(3, np.float32), np.zeros(3, np.float32), np.full(3, 0.5, np.float32)]
    got, _ = tr.update([torch.from_numpy(u) for u in us], (), [torch.from_numpy(p) for p in ps])
    want, _ = jt.update([jnp.asarray(u) for u in us], jt.init(None), [jnp.asarray(p) for p in ps])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_multi_transform_partition_matches_optax(rng):
    """LARS for the weights, SGD for biases and norm / bn parameters, each
    leaf through its own chain, ten steps under the one-cycle schedule."""
    from vittf_tpu.train.paws import _lars_label_fn as jax_labels
    from vittf_tpu_torch.train.paws import _lars_label_fn as port_labels

    tree = _tree(rng)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    # the JAX trees name the norm scale 'scale', the port's 'weight': the
    # labels come from the path, so both trees give the same partition
    labels = jax.tree.leaves(port_labels(tree))
    assert labels == jax.tree.leaves(jax_labels(jtree))
    assert labels.count("lars") == 2  # the conv and the linear weights
    jlr, tlr = optax.cosine_onecycle_schedule(10, 0.1), optim.cosine_onecycle_schedule(10, 0.1)
    jopt = optax.multi_transform(
        {"lars": optax.lars(jlr, weight_decay=1e-6, trust_coefficient=0.001, momentum=0.9),
         "exclude": optax.sgd(jlr, momentum=0.9)}, jax_labels(jtree))
    topt = optim.multi_transform(
        {"lars": optim.lars(tlr, weight_decay=1e-6, trust_coefficient=0.001, momentum=0.9),
         "exclude": optim.sgd(tlr, 0.9)}, labels)
    out, _, _ = _run(jopt, topt, tree, _grads(rng, tree))
    _assert_steps(out)
