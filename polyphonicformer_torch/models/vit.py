"""ViTDet's plain ViT backbone and simple feature pyramid (Li, Mao, Girshick,
He 2022, arXiv:2203.16527), as detectron2 writes them
(``modeling/backbone/vit.py``, ``utils.py``; ``projects/ViTDet/configs``).
The JAX package has no ViT; this module is the port's own.

Channels-last inside the backbone: a 16 x 16 stride-16 patch embedding, the
pretraining position table (a cls row and 14 x 14) resized bicubically to
the grid, then blocks ``x + attn(LN(x))``, ``x + mlp(LN(x))`` (LayerNorm eps
1e-6, exact GELU, no final norm).  Window blocks zero-pad ``LN(x)`` to
multiples of the window (the padded tokens enter every window's softmax as
keys, unmasked, as published); global blocks attend over the whole grid.
Both add the decomposed relative-position term through K10
(``ops/cuda/relpos_attn.py``), the tables of a global block resized
linearly to the grid as ``get_rel_pos`` does, once a forward.  One
departure, with the same result: a window block crops its padded tokens
before ``proj`` rather than after it (the kept tokens are the same, and
``proj`` acts token by token).

The simple feature pyramid turns the stride-16 map into strides 4, 8, 16
and 32 (two deconvolutions with a channel LayerNorm and GELU between; one
deconvolution; the map; a 2 x 2 max-pool), each followed by a 1 x 1 and a
3 x 3 convolution without bias, each with a channel LayerNorm.  No p6 and
no ``square_pad``: the heads read strides 4-32.

Parameter names are detectron2's below ``backbone.net.`` and
``backbone.simfp_*``, which the model puts under ``backbone.`` and
``neck.``.  Spans: ``model/vit_window_attn`` and ``model/vit_global_attn``
hold a block's attention sub-layer, from ``norm1`` through ``proj`` and the
crop, inside ``model/backbone``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.cuda.relpos_attn import relpos_attention
from ..utils.profiling import span

PATCH = 16
PRETRAIN_GRID = 14  # 224 / 16: the pretraining position table, with a cls row
IMG_SIZE = 1024  # detectron2's ``img_size``: global blocks' tables span 2 * 64 - 1 rows
LN_EPS = 1e-6


def get_rel_pos(k: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The table of a k-wide axis: ``rel_pos`` (2k - 1 rows) as it is, or
    resized linearly along its rows (detectron2 ``get_rel_pos``), in f32;
    contiguous, as K10 takes it."""
    n = 2 * k - 1
    if rel_pos.shape[0] == n:
        return rel_pos
    out = F.interpolate(rel_pos.float().t()[None], size=n, mode="linear")
    return out[0].t().contiguous()


def get_abs_pos(pos_embed: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The pretraining table without its cls row, resized bicubically
    (``align_corners=False``) to ``hw``: (1, h, w, C) in f32."""
    g = PRETRAIN_GRID
    grid = pos_embed[:, 1:].float().reshape(1, g, g, -1).permute(0, 3, 1, 2)
    if (g, g) != tuple(hw):
        grid = F.interpolate(grid, size=hw, mode="bicubic", align_corners=False)
    return grid.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


class Attention(nn.Module):
    """qkv and proj with bias, and the rel-pos tables of the block's input
    size (the window, or 1024 / 16 for a global block)."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, window_size or IMG_SIZE // PATCH)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws = self.window_size
        x = self.norm1(x)
        if ws:
            x = F.pad(x, (0, 0, 0, -w % ws, 0, -h % ws))
        kh, kw = (ws, ws) if ws else (h, w)
        attn = self.attn
        dt = x.dtype
        out = relpos_attention(attn.qkv(x), get_rel_pos(kh, attn.rel_pos_h).to(dt),
                               get_rel_pos(kw, attn.rel_pos_w).to(dt), attn.num_heads, ws)
        return attn.proj(out[:, :h, :w])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("model/vit_window_attn" if self.window_size else "model/vit_global_attn"):
            x = x + self._attention(x)
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) with H and W multiples of 16 -> (B, dim, H/16, W/16)."""

    def __init__(self, dim: int, depth: int, num_heads: int, global_blocks: Sequence[int],
                 window_size: int):
        super().__init__()
        self.out_channels = dim
        self.patch_embed = PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + PRETRAIN_GRID ** 2, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, 0 if i in global_blocks else window_size)
            for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, x.shape[1:3]).to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class ChannelNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (detectron2 ``LayerNorm``
    of ``get_norm("LN")``, eps 1e-6)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNorm(nn.Module):
    """detectron2 ``Conv2d(..., bias=False, norm=LN)``: keys ``weight`` and
    ``norm.{weight,bias}``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.norm = ChannelNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        return self.norm(F.conv2d(x, self.weight, padding=k // 2))


class SimpleFeaturePyramid(nn.Module):
    """The stride-16 map -> strides 4, 8, 16, 32 with ``out_channels``
    (branches ``simfp_2`` .. ``simfp_5``)."""

    def __init__(self, dim: int, out_channels: int):
        super().__init__()
        half, quarter = dim // 2, dim // 4

        def tail(cin):
            return [ConvNorm(cin, out_channels, 1), ConvNorm(out_channels, out_channels, 3)]

        self.simfp_2 = nn.Sequential(nn.ConvTranspose2d(dim, half, 2, 2), ChannelNorm(half),
                                     nn.GELU(), nn.ConvTranspose2d(half, quarter, 2, 2),
                                     *tail(quarter))
        self.simfp_3 = nn.Sequential(nn.ConvTranspose2d(dim, half, 2, 2), *tail(half))
        self.simfp_4 = nn.Sequential(*tail(dim))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2), *tail(dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(branch(x).contiguous()
                     for branch in (self.simfp_2, self.simfp_3, self.simfp_4, self.simfp_5))
