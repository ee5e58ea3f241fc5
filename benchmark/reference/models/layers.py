"""Common building blocks (NCHW inside), mirroring
``polyphonicformer_tpu/models/layers.py``.  Parameter and buffer names are
those of the reference mmdet/mmcv modules, so ``state_dict()`` keys equal the
reference checkpoint's keys (``tools/convert_torch_ckpt.py``)."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm(nn.Module):
    """BatchNorm in permanent eval mode: running stats are buffers."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class ConvNormAct(nn.Module):
    """Conv2d -> optional GroupNorm -> optional ReLU (mmcv ConvModule), with
    symmetric k // 2 padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, gn_groups: int = 0, act: bool = True,
                 bias: bool | None = None):
        super().__init__()
        use_bias = bias if bias is not None else gn_groups == 0
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, bias=use_bias)
        self.gn = nn.GroupNorm(gn_groups, out_channels, eps=1e-5) if gn_groups else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x) if self.act else x


class _InProj(nn.Module):
    """Holds torch.nn.MultiheadAttention's parameter names."""

    def __init__(self, c: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with identity residual (mmcv MultiheadAttention over
    torch.nn.MultiheadAttention), written as matmuls: q is scaled before
    QK^T and the softmax runs in f32."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attn = _InProj(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = x @ self.attn.in_proj_weight.t() + self.attn.in_proj_bias
        q, k, v = (t.reshape(b, n, h, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        q = q / math.sqrt(hd)
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return x + self.attn.out_proj(out)


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Linear with identity residual."""

    def __init__(self, embed_dim: int, feedforward_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(embed_dim, feedforward_dim), nn.ReLU()),
            nn.Linear(feedforward_dim, embed_dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers[1](self.layers[0](x))


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0, normalize: bool = True,
                             scale: float = 2 * math.pi, eps: float = 1e-6,
                             dtype=torch.float32, device=None) -> torch.Tensor:
    """DETR-style sine positional encoding, (H, W, 2 * num_feats)."""
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None] \
        * torch.ones((1, w), device=device)
    x_embed = torch.ones((h, 1), device=device) \
        * torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    if normalize:
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_feats)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)
