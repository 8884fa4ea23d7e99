"""Feature extraction: frozen ViT over volume slices, 3-axis merge.

Port of ``vittf_tpu/pipeline/features.py`` (reference infer.py:130-210 and
the ``--slice-along all`` sweep, infer.py:317-333). PyTorch runs eagerly,
so the JAX package's ``lax.scan`` over slice batches is a Python loop with a
carried fp32 accumulator, and the z, y, x sweeps run in turn for every
volume shape (the JAX package fuses them into one jit for cubic volumes;
the numbers are the same). Per slice batch: nearest resize of the raw
slices, global min-max normalization, the ViT with the grayscale replicate
and ImageNet normalization folded into the patch embed, the last block's k
projection, CLS (and register) drop, and the slice-axis adaptive pool as a
weighted accumulation. The three axes are summed as (z + y) + x. The batch loop
(``_accumulate``) takes its batches from a source and carries its fp32
accumulators in and out, so the host-streamed path (``pipeline/streamed.py``)
feeds it chunk by chunk.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vittf_tpu_torch.models.vit import ViTConfig, VisionTransformer, check_block_impl
from vittf_tpu_torch.ops.resize import (
    _adaptive_avg_weight_matrix,
    adaptive_avg_pool,
    resize_nearest,
)
from vittf_tpu_torch.utils.logging import span
from vittf_tpu_torch.utils.tensor import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imagenet_normalize,
    resolve_device,
)

# (permute of (W,H,D) → slice stack, image dims (of im_sz), output axis the
# slice index lands on in the (F, o0, o1, o2) feature volume)
_AXIS_RULES = {
    "z": ((2, 0, 1), (0, 1), 3),  # slices (D, W, H); images (W,H)
    "y": ((1, 0, 2), (0, 2), 2),  # slices (H, W, D); images (W,D)
    "x": ((0, 1, 2), (1, 2), 1),  # slices (W, H, D); images (H,D)
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# volume dtypes kept as they are on the device; others are cast to fp32
_KEEP_DTYPES = (torch.uint8, torch.int16, torch.float16, torch.bfloat16, torch.float32)


@dataclass(frozen=True)
class ExtractConfig:
    """Feature-extraction settings (mirrors the infer CLI surface)."""

    feature_output_size: int = 64
    slice_along: str = "all"  # 'x' | 'y' | 'z' | 'all'
    batch_size: int = 8
    return_keys: tuple = ("k",)
    precision: str = "default"  # 'default' (bf16 speed) | 'highest' (fp32 parity)
    attn_impl: str = "auto"  # 'auto' (CUDA kernel on GPU) | 'plain'
    compute_dtype: str = "float32"  # activation dtype: bfloat16 for speed
    # 'qkv' = DINO path (infer.py hook target); 'mlp' = CLIP/BLIP path
    # (infer_clip.py hooks blocks[-1].mlp and splits the output in thirds)
    feature_source: str = "qkv"
    # Fast mode: run the ViT only on the slices nearest the pooled output
    # grid (the reference's sketched shortcut, infer.py:160-166); NOT
    # artifact-parity with the full sweep.
    slice_subsample: bool = False
    # a name of models/vit.py's BLOCK_IMPLS: 'xla' (per-op blocks) or a fused
    # one (the fused block kernel, bf16 only; 'fused' skips the softmax row max)
    block_impl: str = "xla"

    def pooling(self, axis_mode: str | None = None) -> bool:
        """The slice axis is pooled only in the 'all' sweep (infer.py:329 vs
        :326's pool_fn=_noop)."""
        return (axis_mode or self.slice_along) == "all"

    def feature_dim(self, embed_dim: int) -> int:
        """Channels per returned key: D for 'qkv', D/3 for 'mlp'."""
        return embed_dim if self.feature_source == "qkv" else embed_dim // 3


def compute_im_sizes(
    vol_shape: tuple[int, int, int], feature_output_size: int, patch_size: int
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Reference parity: infer.py:317-319 image/feature size rule."""
    ref_fact = sorted(vol_shape)[1] / feature_output_size
    im_sz = tuple(int(patch_size * (d // ref_fact)) for d in vol_shape)
    feat_out_sz = tuple(d // patch_size for d in im_sz)
    return im_sz, feat_out_sz


def _qkv_index(key: str) -> int:
    return {"q": 0, "k": 1, "v": 2}[key]


def fold_grayscale_patch_embed(state_dict: dict) -> dict:
    """Fold replicate-to-RGB + ImageNet normalize into the patch embed.

    Scalar volumes replicate 1→3 channels before the per-channel ImageNet
    normalize (infer.py:154-155). Both are affine per channel and the patch
    embed is linear over channels, so for a grayscale pixel x:

        Σ_c K[·,c,·]·(x − m_c)/s_c  =  (Σ_c K[·,c,·]/s_c)·x
                                       + (b − Σ_c (m_c/s_c)·Σ_p K[p,c,·])

    Returns a ``state_dict`` with a (D, 1, P, P) patch-embed weight; the
    other tensors are shared, not copied.
    """
    k = state_dict["patch_embed.proj.weight"]  # (D, 3, P, P)
    b = state_dict["patch_embed.proj.bias"]
    inv_std = torch.tensor(IMAGENET_STD, dtype=torch.float32) ** -1
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32)
    kf = k.float()
    k1 = torch.einsum("dchw,c->dhw", kf, inv_std.to(k.device))[:, None]
    shift = torch.einsum("dchw,c->d", kf, (mean * inv_std).to(k.device))
    out = dict(state_dict)
    out["patch_embed.proj.weight"] = k1.to(k.dtype)
    out["patch_embed.proj.bias"] = (b.float() - shift).to(b.dtype)
    return out


def _slice_batch_features(
    model, batch, img_hw, f_hw, key_idx, precision, attn_impl, block_impl, mima,
    feature_source="qkv",
):
    """One (B, C, a, b) raw slice batch through the ViT → per-key
    (B, fh·fw, D) fp32 features from the last block's qkv projection (the
    DINO hook target, infer.py), or (B, fh·fw, D/3) thirds of the last
    block's MLP output for ``feature_source='mlp'`` (infer_clip.py), the
    non-patch tokens (CLS and any registers) dropped. The MLP output needs
    the whole last block, which therefore runs per-op under every
    ``block_impl``.

    ``mima``: the volume's global (min, max) as fp32 scalars; min-max
    normalization runs here, after the nearest resize (which commutes with
    elementwise ops exactly), so the volume stays compact until now.
    """
    dtype = model.cls_token.dtype
    imgs = resize_nearest(batch, img_hw)  # raw dtype
    imgs = (imgs.float() - mima[0]) / (mima[1] - mima[0])
    if imgs.shape[1] == 1 and model.patch_embed.proj.weight.shape[1] == 1:
        # grayscale-folded patch embed: replicate + ImageNet normalize are
        # already in the kernel/bias
        imgs = imgs.to(dtype)
    else:
        if imgs.shape[1] == 1:
            imgs = imgs.expand(-1, 3, -1, -1)  # replicate 1→3 (infer.py:154)
        imgs = imagenet_normalize(imgs).to(dtype)
    # qkv: only the requested thirds of the last block's projection
    thirds = tuple(key_idx) if feature_source == "qkv" else None
    _, qkv = model.forward_raw(
        imgs, precision=precision, attn_impl=attn_impl, return_qkv_last=True,
        capture=feature_source, stop_after_capture=thirds is not None,
        capture_thirds=thirds, block_impl=block_impl,
    )
    n, B = len(key_idx) if thirds is not None else 3, batch.shape[0]
    patches = qkv[:, model.cfg.prefix_tokens:]  # CLS and registers dropped
    feats = patches.reshape(B, f_hw[0] * f_hw[1], n, qkv.shape[-1] // n)
    return [feats[:, :, i if thirds is not None else ki].float()
            for i, ki in enumerate(key_idx)]


def _subsample_slice_indices(S: int, target: int) -> np.ndarray:
    """The reference's commented-out slice pick (infer.py:160-166):
    nearest-resize of arange(S) to ``target`` slices, centered."""
    idx = np.floor(np.arange(target) * (S / target)).astype(np.int64)
    idx = np.minimum(idx, S - 1)
    return idx + (S - idx.max()) // 2


def _predecimate_fast_input(vol, im_sz, feat_out_sz):
    """Fast-mode prefilter: decimate the volume ONCE when every read is
    strided anyway.

    When the in-plane nearest resize is an integer-ratio r subsample and
    every picked plane index is a multiple of r, every element fast mode
    touches lies on the ``vol[::r, ::r, ::r]`` lattice. Element-identical
    by construction; the plane-pick equivalence is checked exactly here,
    with a fall-through to the unfiltered volume where it does not hold.
    The global min/max is taken from the full volume before this runs.
    """
    shp = tuple(vol.shape[-3:])
    if not (shp[0] == shp[1] == shp[2] and im_sz[0] == im_sz[1] == im_sz[2]):
        return vol
    S, im, o_ax = shp[0], im_sz[0], feat_out_sz[0]
    if im >= S or S % im or im <= o_ax:
        return vol
    r = S // im
    pick = _subsample_slice_indices(S, o_ax)
    if np.any(pick % r) or not np.array_equal(
        pick // r, _subsample_slice_indices(im, o_ax)
    ):
        return vol
    return vol[..., ::r, ::r, ::r].contiguous()


def _axis_geometry(cfg, axis, im_sz, feat_out_sz):
    """(permute, image (h, w), token grid (fh, fw), pooled slots, output axis)."""
    perm, im_dims, out_axis = _AXIS_RULES[axis]
    img_hw = (im_sz[im_dims[0]], im_sz[im_dims[1]])
    f_hw = (img_hw[0] // cfg.patch_size, img_hw[1] // cfg.patch_size)
    return perm, img_hw, f_hw, feat_out_sz[out_axis - 1], out_axis


def _axis_pool(S, o_ax, pool, slice_subsample, device):
    """The slice-axis pool of one sweep over S slices: (pick, w_pool, o_ax).

    ``pick``: the slice indices fast mode keeps (None: all); ``w_pool``: the
    (o_ax, S) fp32 pool matrix on ``device``, None for the identity (slice i
    is output slot i); ``o_ax``: the pooled slots.
    """
    if not pool:
        # single-axis reference semantics (infer.py:326 pool_fn=_noop)
        return None, None, S
    if slice_subsample and S > o_ax:
        return _subsample_slice_indices(S, o_ax), None, o_ax  # one slice per slot
    if S == o_ax:
        return None, None, o_ax  # adaptive-pool windows are singletons
    w_pool = torch.from_numpy(_adaptive_avg_weight_matrix(S, o_ax)).float()
    with span("sync.pool"):
        w_pool = w_pool.to(device)
    return None, w_pool, o_ax


def _axis_slices(vol, cfg, axis, im_sz, feat_out_sz, slice_subsample, pool):
    """(S, C, a, b) slice stack (a view where possible), the (o_ax, S) pool
    matrix (None when it is the identity) and the axis geometry."""
    perm, img_hw, f_hw, o_ax, out_axis = _axis_geometry(cfg, axis, im_sz, feat_out_sz)
    vol4 = vol[None] if vol.ndim == 3 else vol  # (C, W, H, D)
    pick, w_pool, o_ax = _axis_pool(vol4.shape[perm[0] + 1], o_ax, pool, slice_subsample,
                                    vol.device)
    if pick is not None:  # pick before the permute
        vol4 = torch.index_select(vol4, perm[0] + 1, torch.from_numpy(pick).to(vol4.device))
    slices = vol4.permute(perm[0] + 1, 0, perm[1] + 1, perm[2] + 1)
    return slices, w_pool, (img_hw, f_hw, o_ax, out_axis)


def _new_accumulators(n_keys, o_ax, f_hw, D, device):
    return [
        torch.zeros((o_ax, f_hw[0] * f_hw[1], D), dtype=torch.float32, device=device)
        for _ in range(n_keys)
    ]


def _accumulate(model, batches, acc, w_pool, img_hw, f_hw, key_idx, cfg, mima):
    """Run ``(s0, batch)`` pairs (batch = slices s0.. of the axis) through the
    ViT into the carried fp32 accumulators, in place; returns them.

    ``w_pool``: the (o_ax, S) slice-axis pool matrix on the accumulators'
    device, or None for the identity (slice i is output slot i).
    """
    for s0, batch in batches:
        with span("features.batch"):
            fks = _slice_batch_features(
                model, batch, img_hw, f_hw, key_idx, cfg.precision, cfg.attn_impl,
                cfg.block_impl, mima, cfg.feature_source,
            )
            for a, fk in zip(acc, fks):
                nb = fk.shape[0]
                if w_pool is None:
                    a[s0:s0 + nb] = fk
                else:
                    # acc += w[:, batch] · fk, in place (fp32 GEMM, no TF32)
                    a.view(a.shape[0], -1).addmm_(w_pool[:, s0:s0 + nb], fk.reshape(nb, -1))
    return acc


def _pooled_to_volume(acc, keys, f_hw, o_ax, out_axis, D):
    """{key: (F, o0, o1, o2)} from the (o_ax, fh·fw, D) accumulators."""
    out = {}
    for name, pooled in zip(keys, acc):
        vol4 = pooled.reshape(o_ax, f_hw[0], f_hw[1], D)
        vol4 = torch.movedim(vol4, -1, 0)  # (F, o_ax, fh, fw)
        out[name] = torch.movedim(vol4, 1, out_axis)
    return out


def _extract_axis(model, vol, mima, model_cfg, cfg, axis, im_sz, feat_out_sz, select=None,
                  reduce=None):
    """One axis sweep → {key: pooled (F, o0, o1, o2) fp32 volume}.

    ``select(n)``: the indices of the n slice batches this process runs (all
    when None); ``reduce``: combines the processes' fp32 accumulators in
    place before they become a volume (``parallel/extract.py``).
    """
    slices, w_pool, (img_hw, f_hw, o_ax, out_axis) = _axis_slices(
        vol, model_cfg, axis, im_sz, feat_out_sz, cfg.slice_subsample,
        # the slice axis is pooled only in the 'all' sweep (infer.py:329 vs :326)
        cfg.slice_along == "all",
    )
    key_idx = tuple(_qkv_index(k) for k in cfg.return_keys)
    B = cfg.batch_size
    nb = -(-slices.shape[0] // B)
    picked = range(nb) if select is None else select(nb)
    batches = ((i * B, slices[i * B:(i + 1) * B].contiguous()) for i in picked)
    D = cfg.feature_dim(model_cfg.embed_dim)
    acc = _new_accumulators(len(key_idx), o_ax, f_hw, D, vol.device)
    acc = _accumulate(model, batches, acc, w_pool, img_hw, f_hw, key_idx, cfg, mima)
    if reduce is not None:
        reduce(acc)
    return _pooled_to_volume(acc, cfg.return_keys, f_hw, o_ax, out_axis, D)


def _pool_to(feat: torch.Tensor, feat_out_sz: tuple[int, int, int]) -> torch.Tensor:
    if tuple(feat.shape[1:]) == tuple(feat_out_sz):
        return feat
    return adaptive_avg_pool(feat, feat_out_sz)


def _build_model(
    params: dict, model_cfg: ViTConfig, compute_dtype: str, device, grayscale: bool
) -> VisionTransformer:
    """The extraction ViT: weights folded for grayscale input when the
    checkpoint is RGB, cast to the compute dtype, on ``device``. The module
    is made on the meta device and takes those tensors as its parameters
    (``assign``): no random init and no copy through the host, whose time
    grows with the model (seconds a call for ViT-g/14). A weight already on
    ``device`` in the compute dtype is shared with ``params``, not copied."""
    if grayscale and params["patch_embed.proj.weight"].shape[1] == 3:
        params = fold_grayscale_patch_embed(params)
    dtype = _DTYPES[compute_dtype]
    weights = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in params.items()}
    with torch.device("meta"):
        model = VisionTransformer(model_cfg, weights["patch_embed.proj.weight"].shape[1])
    model.load_state_dict(weights, assign=True)
    return model.eval().requires_grad_(False)


def extract_features(
    vol,
    params: dict,
    model_cfg: ViTConfig,
    cfg: ExtractConfig = ExtractConfig(),
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """Feature extraction over one, or all three, volume axes.

    ``vol`` is a (W, H, D) scalar or (3, W, H, D) RGB volume (numpy or
    tensor); ``params`` a hub-layout ``state_dict``. Returns
    {key: (F, o0, o1, o2) fp32 tensor on ``device``}, the first CUDA device
    when it is None (``device='cpu'`` runs on the CPU); for
    ``slice_along='all'`` the per-axis pooled volumes are summed.
    """
    return _extract(vol, params, model_cfg, cfg, device)


def _extract(vol, params, model_cfg, cfg, device, select=None, reduce=None):
    """``extract_features``, each sweep over the slice batches ``select``
    picks, its accumulators combined by ``reduce`` (``_extract_axis``)."""
    with span("features.extract"):
        check_block_impl(model_cfg, cfg.block_impl)
        if cfg.feature_source not in ("qkv", "mlp"):
            raise ValueError(f"unknown feature_source: {cfg.feature_source!r}")
        device = resolve_device(device)
        if not torch.is_tensor(vol):
            vol = torch.from_numpy(np.ascontiguousarray(vol))
        if vol.dtype not in _KEEP_DTYPES:
            vol = vol.float()
        with span("sync.volume"):  # a copy only where the volume lies elsewhere
            vol = vol.to(device)
        im_sz, feat_out_sz = compute_im_sizes(
            tuple(vol.shape[-3:]), cfg.feature_output_size, model_cfg.patch_size
        )
        with span("features.build_model"):
            model = _build_model(params, model_cfg, cfg.compute_dtype, device, vol.ndim == 3)
        mima = (vol.min().float(), vol.max().float())
        if cfg.slice_subsample:
            vol = _predecimate_fast_input(vol, im_sz, feat_out_sz)

        axes = ["z", "y", "x"] if cfg.slice_along == "all" else [cfg.slice_along]
        out: dict[str, torch.Tensor] = {}
        for ax in axes:
            with span("features.axis"):
                axis_feats = _extract_axis(
                    model, vol, mima, model_cfg, cfg, ax, im_sz, feat_out_sz, select, reduce
                )
            with span("features.merge"):
                for k, v in axis_feats.items():
                    if cfg.slice_along == "all":
                        v = _pool_to(v, feat_out_sz)  # common grid before summing
                    out[k] = v if k not in out else out[k] + v
        return out
