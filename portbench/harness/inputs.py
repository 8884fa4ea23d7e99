"""Everything a run feeds the program, made from ``--seed``.

The weights and the phantom volume are made on the card in a few large
calls; annotations and strokes are drawn on the host from the phantom's
labels with a numpy ``Generator``. Every seed gives the same sizes: the
five structures keep one table of radii (the seed places them and picks
which class gets which), every class gets the same annotation count, and
every stroke has the same length.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

# semi-axes of the five structures, in units of half the volume's side: a
# seed permutes them over the classes and places them
RADII = ((0.30, 0.25, 0.20), (0.18, 0.28, 0.22), (0.25, 0.18, 0.30),
         (0.22, 0.22, 0.22), (0.34, 0.20, 0.17))
MIN_CLASS_SHARE = 0.5  # of a structure's own voxels left visible by the later ones


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (any integer, also above 2**32)."""
    ss = np.random.SeedSequence([seed % 2**64, zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def host_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def vit_param_shapes(model: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of a DINO ViT's hub ``state_dict`` (the layout of
    ``init_vit_params``), the backbone with its final norm; kind is 'w'
    (weights and embeddings), 'b' (biases), 'g' (LayerNorm gains), 'n'
    (LayerNorm shifts)."""
    D, P, hidden = model["embed_dim"], model["patch_size"], model["hidden_dim"]
    grid = model["img_size"] // P
    out = [("cls_token", (1, 1, D), "w"), ("pos_embed", (1, 1 + grid * grid, D), "w"),
           ("patch_embed.proj.weight", (D, 3, P, P), "w"), ("patch_embed.proj.bias", (D,), "b")]
    for i in range(model["depth"]):
        b = f"blocks.{i}"
        out += [(f"{b}.norm1.weight", (D,), "g"), (f"{b}.norm1.bias", (D,), "n"),
                (f"{b}.attn.qkv.weight", (3 * D, D), "w"), (f"{b}.attn.qkv.bias", (3 * D,), "b"),
                (f"{b}.attn.proj.weight", (D, D), "w"), (f"{b}.attn.proj.bias", (D,), "b"),
                (f"{b}.norm2.weight", (D,), "g"), (f"{b}.norm2.bias", (D,), "n"),
                (f"{b}.mlp.fc1.weight", (hidden, D), "w"), (f"{b}.mlp.fc1.bias", (hidden,), "b"),
                (f"{b}.mlp.fc2.weight", (D, hidden), "w"), (f"{b}.mlp.fc2.bias", (D,), "b")]
    out += [("norm.weight", (D,), "g"), ("norm.bias", (D,), "n")]
    return out


# kind → (scale, shift) of a standard normal draw
_KINDS = {"w": (0.02, 0.0), "b": (0.02, 0.0), "g": (0.1, 1.0), "n": (0.05, 0.0)}


def vit_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A hub-layout fp32 ``state_dict`` drawn on ``device``: one normal draw
    for all of it, scaled per kind (weights 0.02, biases 0.02, LayerNorm gains
    1 ± 0.1, shifts 0.05). Biases and norms are not left at zero and one, so
    the comparison sees every term."""
    shapes = vit_param_shapes(model)
    order = sorted(range(len(shapes)), key=lambda i: "wbgn".index(shapes[i][2]))
    sizes = [int(np.prod(shapes[i][1])) for i in order]
    flat = torch.randn(sum(sizes), generator=device_generator(seed, "weights", device),
                       device=device)
    start = 0
    for kind in "wbgn":
        n = sum(s for i, s in zip(order, sizes) if shapes[i][2] == kind)
        scale, shift = _KINDS[kind]
        flat[start:start + n].mul_(scale).add_(shift)
        start += n
    out, start = {}, 0
    for i, n in zip(order, sizes):
        name, shape, _ = shapes[i]
        out[name] = flat[start:start + n].view(shape)
        start += n
    return {name: out[name] for name, _, _ in shapes}


def phantom(size: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(volume fp32, labels uint8) of side ``size`` on ``device``: five
    ellipsoids of distinct intensity (class c adds 0.2·c) in N(0, 0.05)
    noise, the shape of a CT-ORG labeled volume. The radii are ``RADII``,
    permuted over the classes by the seed; centres are redrawn until every
    class keeps ``MIN_CLASS_SHARE`` of its voxels."""
    rng = host_rng(seed, "phantom geometry")
    ax = torch.linspace(-1.0, 1.0, size, device=device)
    while True:
        radii = np.asarray(RADII)[rng.permutation(len(RADII))]
        centres = rng.uniform(-0.45, 0.45, (len(RADII), 3))
        labels = torch.zeros((size,) * 3, dtype=torch.uint8, device=device)
        own = []
        for c, (cen, rad) in enumerate(zip(centres, radii), start=1):
            inside = (((ax[:, None, None] - cen[0]) / rad[0]) ** 2
                      + ((ax[None, :, None] - cen[1]) / rad[1]) ** 2
                      + ((ax[None, None, :] - cen[2]) / rad[2]) ** 2) <= 1.0
            labels[inside] = c
            own.append(int(inside.sum()))
        counts = torch.bincount(labels.reshape(-1), minlength=len(RADII) + 1)[1:].tolist()
        if all(n >= MIN_CLASS_SHARE * o for n, o in zip(counts, own)):
            break
    vol = 0.05 * torch.randn((size,) * 3, generator=device_generator(seed, "noise", device),
                             device=device)
    vol += 0.2 * labels.float()
    return vol, labels


def annotations_from_labels(labels: np.ndarray, n: int, rng: np.random.Generator
                            ) -> dict[str, np.ndarray]:
    """{'ntf<c>': (n, 3) int64 voxel coordinates} drawn uniformly without
    replacement from each class's voxels in C order: the uniform mode of the
    program's sampler (``pipeline/annotations.py``, reference
    compare_feat_sampling.py:13-33), ``np.argwhere`` then ``rng.choice``."""
    flat = labels.reshape(-1)
    out = {}
    for c in range(1, int(flat.max()) + 1):
        idx = np.flatnonzero(flat == c)
        pick = idx[rng.choice(idx.size, size=min(n, idx.size), replace=False)]
        out[f"ntf{c}"] = np.stack(np.unravel_index(pick, labels.shape), axis=1).astype(np.int64)
    return out


def strokes(labels: np.ndarray, cls: int, count: int, length: int,
            rng: np.random.Generator) -> np.ndarray:
    """(count, length, 3) int64: straight axis-aligned runs of ``length``
    voxels that lie wholly inside class ``cls``, a painting user's strokes."""
    idx = np.flatnonzero(labels.reshape(-1) == cls)
    shape = np.asarray(labels.shape)
    steps = np.arange(length)
    found = []
    for _ in range(64):
        if sum(len(f) for f in found) >= count:
            break
        start = np.stack(np.unravel_index(rng.choice(idx, 4 * count), labels.shape), axis=1)
        axis = rng.integers(0, 3, 4 * count)
        pts = np.repeat(start[:, None, :], length, axis=1)
        pts[np.arange(len(pts)), :, axis] += steps
        ok = (pts < shape).all(axis=(1, 2))
        ok[ok] = (labels[tuple(pts[ok].reshape(-1, 3).T)].reshape(-1, length) == cls).all(axis=1)
        found.append(pts[ok])
    out = np.concatenate(found)[:count]
    if len(out) < count:
        raise ValueError(f"class {cls} holds too few straight runs of {length} voxels")
    return out.astype(np.int64)
