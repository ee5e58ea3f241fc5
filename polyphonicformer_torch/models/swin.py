"""Swin Transformer backbone (Swin v1, tiny to large); mirrors
``polyphonicformer_tpu/models/swin.py`` with both of its window-attention
kernels switched on.

Channels-last inside, as in JAX: 4x4 patch embed, 7x7 windows with the
relative-position bias, shifted windows on every second block, patch
merging between stages.  The four levels (strides 4/8/16/32, each
LayerNorm'd) are returned NCHW for the FPN.  Parameter names are the
reference mmdet keys (``tools/convert_torch_ckpt.py::_swin_mapping``), so
``state_dict()`` loads a reference checkpoint as it is; ``PatchMerging``
gathers each 2x2 patch in the reference's channel-major (unfold) order.

Window attention: a block with at most 12 heads (Swin-L stages 0-1) runs
K8 on the padded, rolled image; every other block (stages 2-3) runs K7 on
partitioned windows (``ops/cuda/window_attn.py``).  The relative-position
bias is gathered in the parameters' dtype and upcast to f32, as in JAX.
Not ported: the paired-window variant (``POLY_WATTN_PAIR``, a TPU lane
packing numerically identical to unpaired windows) and the logical-axis
metadata of tensor parallelism (``partition=True``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.cuda.window_attn import window_attention, window_attn_math
from ..ops.device_tables import device_table

_K8_MAX_HEADS = 12  # JAX swin.py SwinBlock: the fused image-layout kernel up to 12 heads


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(x: torch.Tensor, ws: int, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, x.shape[-1]).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws*ws, ws*ws) additive mask for shifted windows."""
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    attn = (m[:, :, None] != m[:, None, :]) * -100.0
    return attn.astype(np.float32)


# Constants copied to the device once per shape (ops/device_tables.py).
@device_table(maxsize=16)
def _index_on(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_relative_position_index(ws).reshape(-1).astype(np.int64)).to(device)


@device_table(maxsize=64)
def _mask_on(h: int, w: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """The shift mask in f32.  JAX builds it in the compute dtype on the K7
    branch and upcasts it; its values, 0 and -100, are exact in bf16."""
    return torch.from_numpy(_shift_attn_mask(h, w, ws, shift)).to(device)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: statistics and affine in f32, the result in the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class WindowMSA(nn.Module):
    """mmdet ``WindowMSA``'s parameters: qkv, proj and the bias table."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * window_size - 1) ** 2, num_heads)))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self) -> torch.Tensor:
        """(heads, L, L) f32, gathered in the table's dtype, then upcast."""
        l = self.window_size ** 2
        table = self.relative_position_bias_table
        idx = _index_on(self.window_size, table.device)
        return table[idx].reshape(l, l, self.num_heads).permute(2, 0, 1).float().contiguous()


class ShiftWindowMSA(nn.Module):
    """Pad to window multiples, roll, window attention, roll back, crop."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int):
        super().__init__()
        self.shift = shift
        self.w_msa = WindowMSA(dim, num_heads, window_size)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        b, h, w, c = y.shape
        attn = self.w_msa
        ws, s = attn.window_size, self.shift
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        if (hp, wp) != (h, w):
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = _mask_on(hp, wp, ws, s, y.device)
        bias = attn.bias()
        if attn.num_heads <= _K8_MAX_HEADS:  # K8 on the image layout
            y = attn.proj(window_attention(attn.qkv(y), bias, mask, attn.num_heads, ws))
        else:  # K7 on partitioned windows
            win = attn.qkv(window_partition(y, ws))
            win = attn.proj(window_attn_math(win, bias, mask, attn.num_heads))
            y = window_unpartition(win, ws, (hp, wp))
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        return y[:, :h, :w]


class SwinFFN(nn.Module):
    """mmcv FFN's parameter names: Linear -> exact (erf) GELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
                                     nn.Linear(hidden, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](self.layers[0](x))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, shift)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.ffn = SwinFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dim, eps=1e-5)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        # (c, py, px) channel-major, the reference's nn.Unfold order
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class PatchEmbed(nn.Module):
    """4x4 stride-4 convolution with flax's SAME padding, then LayerNorm;
    NCHW in, channels-last out."""

    def __init__(self, dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.projection = nn.Conv2d(3, dim, patch, patch)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
            total = max((-(-size // self.patch) - 1) * self.patch + self.patch - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        return self.norm(self.projection(x).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 out_dim: int | None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2)
            for b in range(depth))
        self.downsample = PatchMerging(dim, out_dim) if out_dim is not None else None


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7):
        super().__init__()
        dims = [embed_dim * 2 ** s for s in range(len(depths))]
        self.out_channels = tuple(dims)
        self.patch_embed = PatchEmbed(embed_dim)
        self.stages = nn.ModuleList(
            SwinStage(dims[s], depths[s], num_heads[s], window_size,
                      dims[s + 1] if s + 1 < len(depths) else None)
            for s in range(len(depths)))
        for s, dim in enumerate(dims):
            self.add_module(f"norm{s}", LayerNorm(dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: (B, 3, H, W) normalized.  Returns one NCHW level per stage."""
        x = self.patch_embed(x)
        outs = []
        for s, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
