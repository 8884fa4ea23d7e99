"""The optax pieces the trainers use, written to optax's arithmetic.

The JAX twins take their optimizers from optax (0.2.6): ``radam`` with
``add_decayed_weights`` chained in front (``train/contrastive.py``), and
``lars`` for weights beside ``sgd(momentum=0.9)`` for biases and norm
parameters under ``multi_transform`` (``train/paws.py``). torch's classes
compute other functions: ``torch.optim.RAdam`` adds eps to √v before the
bias correction where optax adds it to √v̂, ``OneCycleLR`` peaks a step
earlier and ends at another value, and the usual LARS recipes scale by the
learning rate after the momentum, where optax's ``lars`` scales before it.
So each piece is written here as optax writes it, with optax's defaults as
constants, on lists of tensors, and held against optax number by number in
the tests.

A transform is a pair of functions, as in optax: ``init(params)`` → state and
``update(grads, state, params)`` → (updates, state), over lists of tensors.
Step counts and the scalars derived from them (bias corrections, the
rectification, schedule values) are fp32 tensors, as they are under jit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

Schedule = Callable[[int], torch.Tensor]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _empty(params):
    return ()


def _on(scalars, like: list[torch.Tensor]):
    """Host fp32 scalars as 0-dim tensors on the tensors' device: a CPU
    scalar in a CUDA division would become a multiply by its reciprocal."""
    dev = like[0].device if like else torch.device("cpu")
    return [x.to(dev) for x in scalars]


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def apply_updates(params: list[torch.Tensor], updates: list[torch.Tensor]) -> None:
    """``optax.apply_updates``, in place."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


# ---------------- schedules ----------------

def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` (α 0, exponent 1):
    init · ½(1 + cos(π·min(t, T)/T))."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        t = torch.minimum(_f32(count), _f32(float(decay_steps)))
        return init_value * (0.5 * (1 + torch.cos(math.pi * t / float(decay_steps))))

    return schedule


def _piecewise_cosine(init_value: float, boundaries_and_scales: dict[int, float]) -> Schedule:
    """``optax.piecewise_interpolate_schedule('cosine', ...)``: values
    accumulated by the scales at the boundaries, cosine-interpolated within
    each interval, the value of the one interval holding the step picked by
    a dot product (so a zero-width interval's 0/0 reaches every step, as in
    optax)."""
    boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = torch.from_numpy(np.stack((0,) + boundaries).astype(np.int32))
    values = np.cumprod(np.stack((init_value,) + scales))  # float64, as in optax
    sizes = bounds[1:] - bounds[:-1]
    # optax takes (start - end) / 2 in float64 before its fp32 product
    end, half = (torch.from_numpy(v.astype(np.float32))
                 for v in (values[1:], (values[:-1] - values[1:]) / 2.0))
    last = torch.tensor(values[-1], dtype=torch.float32)

    def schedule(count):
        c = torch.tensor(count, dtype=torch.int32)
        indicator = (bounds[:-1] <= c) & (c < bounds[1:])
        pct = (c - bounds[:-1]) / sizes
        interp = end + half * (torch.cos(math.pi * pct) + 1)
        return (indicator.float() * interp).sum() + (bounds[-1] <= c) * last

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float) -> Schedule:
    """``optax.cosine_onecycle_schedule`` at its defaults: from peak / 25 up
    to the peak at ``int(0.3·n)``, down to peak / 25e4 at ``n``. NaN at
    every step for n ≤ 3, where the first interval has zero width, as in
    optax."""
    return _piecewise_cosine(peak_value / 25.0, {
        int(0.3 * transition_steps): 25.0,
        int(transition_steps): 1.0 / (25.0 * 1e4),
    })


# ---------------- transforms ----------------

def scale_by_learning_rate(learning_rate: float | Schedule) -> Transform:
    """Multiply by −lr; a schedule is read at the count of earlier updates."""
    if not callable(learning_rate):
        return Transform(_empty, lambda g, s, p: ([-learning_rate * x for x in g], s))

    def update(grads, count, params):
        step = _on((-1 * learning_rate(count),), grads)[0]
        return [step * x for x in grads], count + 1

    return Transform(lambda params: 0, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """g + wd·p (coupled decay, before the rest of the chain)."""
    return Transform(_empty, lambda g, s, p: ([x + weight_decay * w for x, w in zip(g, p)], s))


def trace(decay: float) -> Transform:
    """t ← g + decay·t; the update is the new trace."""
    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(grads, state, params):
        new = [g + decay * t for g, t in zip(grads, state)]
        return new, new

    return Transform(init, update)


def scale_by_trust_ratio(trust_coefficient: float) -> Transform:
    """u · coef·|p| / |u| per tensor, or u where either norm is 0."""
    def update(grads, state, params):
        out = []
        for u, p in zip(grads, params):
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = trust_coefficient * pn / un
            ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio), ratio)
            out.append(u * ratio)
        return out, state

    return Transform(_empty, update)


class RAdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def scale_by_radam() -> Transform:
    """``optax.scale_by_radam`` at its defaults (β₁ 0.9, β₂ 0.999, eps 1e-8,
    threshold 5): bias-corrected moments, and where ρ_t ≥ 5 the rectified
    m̂·r / (√v̂ + eps), else m̂."""
    b1, b2, eps, threshold = 0.9, 0.999, 1e-8, 5.0
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return RAdamState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * g**2 + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        t = _f32(float(count))
        b2t = _f32(b2) ** t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        c1, c2, r = _on((1 - _f32(b1) ** t, 1 - b2t, r), grads)
        mu_hat = [m / c1 for m in mu]
        if ro >= threshold:
            out = [r * m / (torch.sqrt(v / c2) + eps) for m, v in zip(mu_hat, nu)]
        else:
            out = mu_hat
        return out, RAdamState(count, mu, nu)

    return Transform(init, update)


# ---------------- optimizers ----------------

def radam(learning_rate: float | Schedule) -> Transform:
    return chain(scale_by_radam(), scale_by_learning_rate(learning_rate))


def sgd(learning_rate: float | Schedule, momentum: float) -> Transform:
    """A trace, then the learning rate."""
    return chain(trace(momentum), scale_by_learning_rate(learning_rate))


def lars(learning_rate: float | Schedule, weight_decay: float, trust_coefficient: float,
         momentum: float) -> Transform:
    """``optax.lars`` (eps 0): decayed weights, the trust ratio, the
    learning rate, then the trace, so the momentum buffer holds lr-scaled
    updates."""
    return chain(add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(trust_coefficient),
                 scale_by_learning_rate(learning_rate),
                 trace(momentum))


def multi_transform(transforms: dict[str, Transform], labels: list[str]) -> Transform:
    """Each tensor through the transform of its label (one label per tensor,
    in the order of the params lists)."""
    groups = {k: [i for i, lab in enumerate(labels) if lab == k] for k in transforms}

    def init(params):
        return {k: t.init([params[i] for i in groups[k]]) for k, t in transforms.items()}

    def update(grads, state, params):
        out, new_state = [None] * len(grads), {}
        for k, t in transforms.items():
            idx = groups[k]
            upd, new_state[k] = t.update([grads[i] for i in idx], state[k],
                                         [params[i] for i in idx])
            for i, u in zip(idx, upd):
                out[i] = u
        return out, new_state

    return Transform(init, update)


# ---------------- parameter trees ----------------

def tree_leaves(tree) -> list:
    """The leaves of nested dicts / lists / tuples, dicts in their key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree; a path holds dict keys and list
    indices as strings, as optax's label functions read them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def trainable(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves require grad."""
    return tree_map_with_path(
        lambda _, t: t.detach().to(device, copy=True).requires_grad_(True), tree)


def update_step(opt: Transform, opt_state, params, loss_fn):
    """One optimizer step: ``loss_fn(params)`` → (loss, aux), its gradient
    with respect to every leaf of ``params`` (zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives), the update applied to the leaves in
    place. Returns (opt_state, loss, aux), loss and aux detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, aux = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        updates, opt_state = opt.update(list(grads), opt_state, leaves)
        apply_updates(leaves, updates)
    return opt_state, loss.detach(), aux
