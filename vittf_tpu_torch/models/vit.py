"""Vision Transformer (DINO / DINOv2 family) as a PyTorch ``nn.Module``.

Port of ``vittf_tpu/models/vit.py``. Parameter names are those of the DINO
hub checkpoints (``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ...), so a
hub ``state_dict`` loads with ``load_state_dict``. The last block's qkv
projection is an explicit output of ``forward_raw``, as in the JAX package.

Numerics follow the JAX forward:
- speed mode (module in bf16, ``precision='default'``): bf16 activations
  and matmuls, fp32 LayerNorm statistics, tanh GELU;
- parity mode (module in fp32, ``precision='highest'``): fp32 throughout,
  exact erf GELU.
The compute dtype is the module's parameter dtype (``model.to(dtype)``).
``forward_raw`` is the inference path (no autograd graph); ``forward`` is
the same forward for training (``train/vit_ssl.py``): autograd
differentiates it, and it takes the plain attention. Per-op blocks
(``block_impl='xla'``) run attention through
``vittf_tpu_torch.ops.attention`` (the CUDA kernel on CUDA tensors) and the
linears as plain ``torch`` matmuls; ``block_impl='fused*'`` runs each
non-final bf16 block through ``vittf_tpu_torch.ops.fused_block`` (K3). The
token-GEMM patch embed is a plain ``torch`` matmul.

DINOv2's larger models add what the JAX package does not hold (facebookresearch/
dinov2 ``vision_transformer.py``): a SwiGLU FFN (``ffn='swiglu'``: ``mlp.w12``
then ``silu(x1)·x2`` through ``vittf_tpu_torch.ops.swiglu`` then ``mlp.w3``),
register tokens (inserted after CLS, without a position embedding) and the
position grid resized to a size with antialiasing (``interpolate_offset`` 0,
``interpolate_antialias``). The captured tokens start with
``ViTConfig.prefix_tokens`` non-patch tokens: CLS and the registers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vittf_tpu_torch.ops.attention import multi_head_attention
from vittf_tpu_torch.ops.fused_block import fused_block
from vittf_tpu_torch.ops.resize import resize_cubic_scaled
from vittf_tpu_torch.ops.swiglu import swiglu


_BLOCK_IMPLS = ("xla", "fused", "fused_rows", "fused_nomax", "fused_rows_nomax")


@dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters for one DINO/DINOv2 ViT variant."""

    patch_size: int = 8
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    img_size: int = 224
    layerscale: bool = False  # DINOv2 uses LayerScale, DINO v1 does not
    name: str = "vits8"
    # DINOv2's names: 'mlp' (fc1, GELU, fc2) or 'swiglu' (w12, silu(x1)·x2, w3)
    ffn: str = "mlp"
    num_register_tokens: int = 0
    # position grid resize: scale (h + offset) / grid (DINO v1's rule), or
    # to the size (h, w) when the offset is 0; antialiased or not
    interpolate_antialias: bool = False
    interpolate_offset: float = 0.1

    def __post_init__(self):
        if self.ffn not in ("mlp", "swiglu"):
            raise ValueError(f"unknown ffn: {self.ffn!r}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def pos_grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def hidden_dim(self) -> int:
        hidden = int(self.embed_dim * self.mlp_ratio)
        if self.ffn == "swiglu":
            # DINOv2's SwiGLUFFNFused: two thirds of the MLP width, rounded up to 8
            return (int(hidden * 2 / 3) + 7) // 8 * 8
        return hidden

    @property
    def prefix_tokens(self) -> int:
        """Tokens ahead of the patches: CLS and the registers."""
        return 1 + self.num_register_tokens


def init_vit_params(
    cfg: ViTConfig, key=(0, 0), dtype=torch.float32
) -> dict[str, torch.Tensor]:
    """Random (trunc-normal 0.02) weights as a hub-layout ``state_dict``.

    Reproduces the JAX package's host-side draws exactly:
    ``init_vit_params(cfg, jax.random.PRNGKey(s))`` seeds
    ``np.random.default_rng(list(key))`` and draws in a fixed order (patch
    embed, pos embed, then qkv/proj/fc1/fc2 per block); ``key`` here is that
    list, ``(0, 0)`` for ``PRNGKey(0)``. Kernels are drawn in the JAX layout
    (HWIO conv, (in, out) linears) and transposed into torch's. A SwiGLU FFN
    draws w12/w3 where fc1/fc2 would be, and register tokens are drawn last,
    so a configuration without either draws what it always drew.
    """
    rng = np.random.default_rng(list(key))

    def tn(shape, std=0.02):
        # rejection-sampled truncation at ±2σ, as in the JAX package
        x = rng.standard_normal(shape)
        bad = np.abs(x) > 2
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > 2
        return torch.from_numpy(np.asarray(x * std, np.float32)).to(dtype)

    D, P = cfg.embed_dim, cfg.patch_size
    zeros = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
    ones = lambda *s: torch.ones(s, dtype=dtype)  # noqa: E731
    sd = {
        "cls_token": zeros(1, 1, D),
        "patch_embed.proj.weight": tn((P, P, 3, D)).permute(3, 2, 0, 1).contiguous(),
        "patch_embed.proj.bias": zeros(D),
        "pos_embed": tn((1, 1 + cfg.pos_grid**2, D)),
        "norm.weight": ones(D),
        "norm.bias": zeros(D),
    }
    H = cfg.hidden_dim
    ffn = ((("mlp.w12", D, 2 * H), ("mlp.w3", H, D)) if cfg.ffn == "swiglu"
           else (("mlp.fc1", D, H), ("mlp.fc2", H, D)))
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        for name, din, dout in (("attn.qkv", D, 3 * D), ("attn.proj", D, D), *ffn):
            sd[f"{b}.{name}.weight"] = tn((din, dout)).T.contiguous()
            sd[f"{b}.{name}.bias"] = zeros(dout)
        for ln in ("norm1", "norm2"):
            sd[f"{b}.{ln}.weight"] = ones(D)
            sd[f"{b}.{ln}.bias"] = zeros(D)
        if cfg.layerscale:
            sd[f"{b}.ls1.gamma"] = torch.full((D,), 1e-5, dtype=dtype)
            sd[f"{b}.ls2.gamma"] = torch.full((D,), 1e-5, dtype=dtype)
    if cfg.num_register_tokens:
        sd["register_tokens"] = tn((1, cfg.num_register_tokens, D))
    return sd


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    # statistics in fp32 for bf16 activation runs, then scale/shift in x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + ln.eps)).to(x.dtype)
    return y * ln.weight + ln.bias


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_hw: tuple[int, int], offset: float = 0.1,
    antialias: bool = False,
) -> torch.Tensor:
    """Resize pos_embed (1, 1+G*G, D) to a (h, w) token grid.

    CLS position kept; patch grid resized bicubically (align_corners=False,
    A=-0.75). DINO parity (``offset`` 0.1, no antialias): DINO's
    ``scale_factor=(h+0.1)/G`` coordinate arithmetic, as the JAX package
    computes it. Otherwise DINOv2's ``interpolate_pos_encoding``: torch's
    bicubic in fp32, to the size (h, w) when ``offset`` is 0, else at the
    scale (h + offset) / G, antialiased when ``antialias``.
    """
    h, w = grid_hw
    g = int(round(float(np.sqrt(pos_embed.shape[1] - 1))))
    if (h, w) == (g, g):
        return pos_embed
    patch_pos = pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    if offset and not antialias:
        patch_pos = resize_cubic_scaled(
            patch_pos, (h, w), (g / (h + offset), g / (w + offset))
        )
    else:
        size = dict(size=(h, w)) if not offset else dict(
            scale_factor=((h + offset) / g, (w + offset) / g))
        patch_pos = F.interpolate(patch_pos.float(), mode="bicubic", antialias=antialias,
                                  **size).to(pos_embed.dtype)
    patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, h * w, -1)
    return torch.cat([pos_embed[:, :1], patch_pos], dim=1)


def embed_tokens(images, weight, bias, cls_token, pos_embed, register_tokens=None,
                 offset: float = 0.1, antialias: bool = False) -> torch.Tensor:
    """Patch embed as a token GEMM + CLS + interpolated pos embed, then the
    register tokens (if any) after CLS, without a position embedding
    (DINOv2's ``prepare_tokens_with_masks``).

    The stride-P conv (``weight`` (D, C, P, P)) is a disjoint patch regroup
    and one (h·w, P²C) × (P²C, D) matmul, with the (i, j, c) contraction
    order of the JAX package's HWIO kernel reshape. ``offset`` and
    ``antialias``: the position grid's resize (``interpolate_pos_embed``).
    """
    D, C, P, _ = weight.shape
    B, _, H, W = images.shape
    h, ww = H // P, W // P
    xp = images.to(weight.dtype).reshape(B, C, h, P, ww, P)
    xp = xp.permute(0, 2, 4, 3, 5, 1).reshape(B, h * ww, P * P * C)
    kernel = weight.permute(2, 3, 1, 0).reshape(P * P * C, D)
    x = torch.matmul(xp, kernel) + bias
    x = torch.cat([cls_token.expand(B, 1, D).to(x.dtype), x], dim=1)
    x = x + interpolate_pos_embed(pos_embed, (h, ww), offset, antialias).to(x.dtype)
    if register_tokens is None:
        return x
    regs = register_tokens.expand(B, -1, -1).to(x.dtype)
    return torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def check_fused_ffn(cfg: ViTConfig, block_impl: str) -> None:
    """Raise where ``block_impl`` asks the fused block (K3), which computes a
    GELU MLP, to run ``cfg``'s SwiGLU blocks."""
    if block_impl.startswith("fused") and cfg.ffn != "mlp":
        raise ValueError(f"the fused block computes a GELU MLP; {cfg.name}'s {cfg.ffn} "
                         f"FFN runs with block_impl='xla'")


class SwiGLUFFN(nn.Module):
    """DINOv2's ``SwiGLUFFNFused``: w12 gives [x1 | x2], then w3(silu(x1)·x2)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-LN transformer block (hub names norm1/attn/norm2/mlp[/ls1/ls2])."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.ffn = cfg.ffn
        self.norm1 = nn.LayerNorm(D, eps=1e-6)
        self.attn = Attention(D)
        self.norm2 = nn.LayerNorm(D, eps=1e-6)
        self.mlp = (SwiGLUFFN if cfg.ffn == "swiglu" else Mlp)(D, cfg.hidden_dim)
        if cfg.layerscale:
            self.ls1 = LayerScale(D)
            self.ls2 = LayerScale(D)

    def forward(self, x, precision="default", attn_impl="auto", capture=None):
        """Returns (x, captured): captured is the qkv projection output
        ('qkv'), the MLP output before the residual ('mlp') or None.
        ``attn_impl`` ('auto' | 'plain') picks the kernels or the plain twins
        for the attention and the SwiGLU gate alike."""
        qkv = self.attn.qkv(_layer_norm(x, self.norm1))  # (B, N, 3D)
        a = multi_head_attention(qkv, self.num_heads, attn_impl)
        a = self.attn.proj(a)
        if hasattr(self, "ls1"):
            a = a * self.ls1.gamma
        x = x + a
        y = _layer_norm(x, self.norm2)
        if self.ffn == "swiglu":
            y = self.mlp.w3(swiglu(self.mlp.w12(y), attn_impl))
        else:
            # parity mode uses torch's exact erf GELU, speed mode the tanh form
            y = F.gelu(self.mlp.fc1(y), approximate="none" if precision == "highest" else "tanh")
            y = self.mlp.fc2(y)
        if hasattr(self, "ls2"):
            y = y * self.ls2.gamma
        x = x + y
        captured = {"qkv": qkv, "mlp": y}.get(capture) if capture else None
        return x, captured


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, in_chans: int):
        super().__init__()
        P = cfg.patch_size
        self.proj = nn.Conv2d(in_chans, cfg.embed_dim, kernel_size=P, stride=P)


class VisionTransformer(nn.Module):
    """DINO/DINOv2 backbone. ``in_chans=1`` holds a grayscale-folded patch
    embed (pipeline/features.fold_grayscale_patch_embed)."""

    def __init__(self, cfg: ViTConfig, in_chans: int = 3):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.patch_embed = PatchEmbed(cfg, in_chans)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid**2, D))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, D))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(D, eps=1e-6)

    @classmethod
    def from_state_dict(cls, cfg: ViTConfig, state_dict: dict) -> "VisionTransformer":
        """Build with the patch embed's channel count taken from the weights."""
        in_chans = state_dict["patch_embed.proj.weight"].shape[1]
        model = cls(cfg, in_chans).to(state_dict["pos_embed"].dtype)
        model.load_state_dict(state_dict)
        return model.eval().requires_grad_(False)

    def _embed(self, images: torch.Tensor) -> torch.Tensor:
        return embed_tokens(images, self.patch_embed.proj.weight, self.patch_embed.proj.bias,
                            self.cls_token, self.pos_embed, getattr(self, "register_tokens", None),
                            self.cfg.interpolate_offset, self.cfg.interpolate_antialias)

    @torch.no_grad()
    def forward_raw(
        self,
        images: torch.Tensor,
        precision: str = "default",
        attn_impl: str = "auto",
        return_qkv_last: bool = True,
        capture: str = "qkv",
        stop_after_capture: bool = False,
        capture_thirds: tuple | None = None,
        block_impl: str = "xla",
    ):
        """Run the ViT over (B, C, H, W) images (H, W multiples of the patch).

        Returns (tokens, qkv_last): tokens (B, T+hw, D) after the final
        LayerNorm (None when ``stop_after_capture``), T the config's
        ``prefix_tokens`` (CLS, then the registers); qkv_last the last
        block's capture, (B, T+hw, 3D) for 'qkv', or
        (B, T+hw, len(capture_thirds)·D) when ``capture_thirds`` narrows
        the projection to those column blocks (q=0, k=1, v=2).

        ``block_impl``: 'xla' (per-op blocks) or 'fused[_rows][_nomax]': the
        fused block for every block whose output is not captured, when the
        module is bf16 ('_rows' picks the TPU's row-grid body, the same
        values; '_nomax' skips the softmax row max). An fp32 module keeps the
        per-op blocks, as the JAX package does. The fused block computes a
        GELU MLP: a SwiGLU model raises ``ValueError`` for 'fused*'.
        """
        return self._forward(images, precision, attn_impl, return_qkv_last, capture,
                             stop_after_capture, capture_thirds, block_impl)

    def forward(
        self,
        images: torch.Tensor,
        precision: str = "default",
        return_qkv_last: bool = True,
        capture: str = "qkv",
        stop_after_capture: bool = False,
        capture_thirds: tuple | None = None,
    ):
        """``forward_raw`` for training: the same embed, blocks and capture,
        with an autograd graph (``torch.func.functional_call`` runs it on a
        parameter dict). Attention takes the plain twin on every device: the
        attention kernel has no backward, as the JAX package trains through
        its XLA attention because the Pallas kernel has no JVP. Per-op
        blocks only."""
        return self._forward(images, precision, "plain", return_qkv_last, capture,
                             stop_after_capture, capture_thirds, "xla")

    def _forward(self, images, precision, attn_impl, return_qkv_last, capture,
                 stop_after_capture, capture_thirds, block_impl):
        """The forward of ``forward_raw`` and ``forward``."""
        if block_impl not in _BLOCK_IMPLS:
            raise ValueError(f"unknown block_impl: {block_impl!r}")
        check_fused_ffn(self.cfg, block_impl)
        x = self._embed(images)
        use_fused = block_impl != "xla" and x.dtype == torch.bfloat16
        qkv_last = None
        depth = len(self.blocks)
        for i, blk in enumerate(self.blocks):
            is_last = i == depth - 1
            want = capture if (return_qkv_last and is_last) else None
            if stop_after_capture and is_last and want == "qkv":
                # the last block's qkv projection depends only on LN1(x): the
                # rest of the block and the final LayerNorm are dead compute
                y = _layer_norm(x, blk.norm1)
                weight, bias = blk.attn.qkv.weight, blk.attn.qkv.bias
                if capture_thirds is not None:
                    D = self.cfg.embed_dim
                    weight = torch.cat([weight[t * D:(t + 1) * D] for t in capture_thirds])
                    bias = torch.cat([bias[t * D:(t + 1) * D] for t in capture_thirds])
                return None, F.linear(y, weight, bias)
            if use_fused and want is None:
                x = fused_block(
                    x, blk, self.cfg.num_heads,
                    impl="rows" if "_rows" in block_impl else "loop",
                    softmax_max="_nomax" not in block_impl,
                )
                continue
            x, cap = blk(x, precision, attn_impl, capture=want)
            if cap is not None:
                qkv_last = cap
        return _layer_norm(x, self.norm), qkv_last


def split_qkv(
    qkv: torch.Tensor, num_heads: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, 3D) → three (B, N, D) tensors via the DINO head reshape.

    Matches the reference's post-hook reshape (infer.py:189-207): view as
    (B, N, 3, heads, hd), take q/k/v, re-merge heads to (B, N, D).
    """
    B, N, threeD = qkv.shape
    D = threeD // 3
    parts = qkv.reshape(B, N, 3, num_heads, D // num_heads)
    q, k, v = (parts[:, :, i] for i in range(3))
    return q.reshape(B, N, D), k.reshape(B, N, D), v.reshape(B, N, D)
