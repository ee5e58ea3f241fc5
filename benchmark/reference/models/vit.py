"""ViTDet's ViT backbone and simple feature pyramid (Li, Mao, Girshick, He
2022, arXiv:2203.16527) in plain ``torch`` ops: the benchmark's copy of the
reference, written from the published equations.

It follows detectron2 (``modeling/backbone/vit.py``: ``Attention``,
``Block``, ``ViT``, ``SimpleFeaturePyramid``; ``modeling/backbone/utils.py``:
``window_partition``, ``window_unpartition``, ``get_rel_pos``,
``add_decomposed_rel_pos``, ``get_abs_pos``; ``layers``: ``LayerNorm``,
``Conv2d`` with a norm) with the relative-position bias materialised as an
L x L tensor, per block of query rows (at most ``CHUNK`` scores at once: a
global block at 1024 x 2048 attends over 8,192 tokens).  It imports nothing
of the program under test.  Under ``reference/models/polyphonic.py`` the
ViT's keys are ``backbone.`` for detectron2's ``backbone.net.`` and the
pyramid's ``neck.simfp_*`` for ``backbone.simfp_*``.

Departures from detectron2, none of which moves a number: no drop path
(eval), no ``use_abs_pos`` or ``use_rel_pos`` switches (both on), no
``square_pad`` and no p6 (``LastLevelMaxPool``), the ``(B, C, H, W)`` output
map returned as it is rather than in a dict; the pyramid returns its four
levels as a tuple in stride order.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

PATCH = 16
PRETRAIN_GRID = 14
IMG_SIZE = 1024
CHUNK = 1 << 28  # scores a block of query rows holds


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size, y0=0):
    """detectron2's, for the query rows y0 .. y0 + q.shape[1] / q_w - 1."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    q_h = q.shape[1] // q_w
    Rh = Rh[y0:y0 + q_h]
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def get_abs_pos(abs_pos, hw):
    h, w = hw
    abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    if size != h or size != w:
        new_abs_pos = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
                                    size=(h, w), mode="bicubic", align_corners=False)
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, PATCH, PATCH)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        rows = max(1, min(H, CHUNK // (q.shape[0] * H * W * W)))
        out = []
        for y0 in range(0, H, rows):  # query rows y0 .. y1 - 1 of every image and head
            y1 = min(H, y0 + rows)
            qc = q[:, y0 * W:y1 * W]
            attn = (qc * self.scale) @ k.transpose(-2, -1)
            attn = add_decomposed_rel_pos(attn, qc, self.rel_pos_h, self.rel_pos_w, (H, W),
                                          (H, W), y0)
            out.append(attn.softmax(dim=-1) @ v)
        x = torch.cat(out, 1).view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(B, H, W, -1))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window_size if window_size > 0 else IMG_SIZE // PATCH)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * 4.0))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, embed_dim, depth, num_heads, global_blocks, window_size):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + PRETRAIN_GRID ** 2, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, 0 if i in global_blocks else window_size)
            for i in range(depth))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class LayerNorm(nn.Module):
    """detectron2's channel-first LayerNorm."""

    def __init__(self, normalized_shape, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class Conv2d(nn.Conv2d):
    """detectron2's ``Conv2d`` with a norm after the convolution."""

    def __init__(self, *args, norm=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        x = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return self.norm(x) if self.norm is not None else x


class SimpleFeaturePyramid(nn.Module):
    def __init__(self, dim, out_channels, scale_factors=(4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.stages = []
        for scale in scale_factors:
            out_dim = dim
            if scale == 4.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, kernel_size=2, stride=2),
                          LayerNorm(dim // 2), nn.GELU(),
                          nn.ConvTranspose2d(dim // 2, dim // 4, kernel_size=2, stride=2)]
                out_dim = dim // 4
            elif scale == 2.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, kernel_size=2, stride=2)]
                out_dim = dim // 2
            elif scale == 1.0:
                layers = []
            else:
                layers = [nn.MaxPool2d(kernel_size=2, stride=2)]
            layers.extend([
                Conv2d(out_dim, out_channels, kernel_size=1, bias=False,
                       norm=LayerNorm(out_channels)),
                Conv2d(out_channels, out_channels, kernel_size=3, padding=1, bias=False,
                       norm=LayerNorm(out_channels))])
            stage = int(math.log2(16 / scale))
            layers = nn.Sequential(*layers)
            self.add_module(f"simfp_{stage}", layers)
            self.stages.append(layers)

    def forward(self, x):
        return tuple(stage(x) for stage in self.stages)
