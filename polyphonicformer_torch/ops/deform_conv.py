"""Deformable convolution v1 (mmcv ``DeformConv2dPack``) as a bilinear
gather of the offset taps and a matmul; mirrors
``polyphonicformer_tpu/ops/deform_conv.py``.  The learned offset conv
(zero-initialised in the reference) predicts a (dy, dx) per kernel tap and
output position; each tap samples the input bilinearly with zero padding,
and the K*K sampled maps contract with the weight in one product.  The
machine with the card has no torchvision, so ``torchvision.ops.deform_conv2d``
is not used."""
from __future__ import annotations

import torch
from torch import nn


def _bilinear_gather(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """feat: (B, C, H, W); ys, xs: (B, Ho, Wo) sample coordinates in pixels.
    Each of the four corner taps outside the map contributes zero (the JAX
    package's sum, in its order).  Returns (B, C, Ho, Wo)."""
    b, c, h, w = feat.shape
    flat = feat.reshape(b, c, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0

    def tap(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(b, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(b, c, idx.shape[-1])).reshape(b, c, *ys.shape[1:])
        return vals * (wgt * inside.to(feat.dtype))[:, None]

    return (tap(y0, x0, (1 - ly) * (1 - lx)) + tap(y0, x0 + 1, (1 - ly) * lx)
            + tap(y0 + 1, x0, ly * (1 - lx)) + tap(y0 + 1, x0 + 1, ly * lx))


class DeformConv2d(nn.Module):
    """k x k deformable conv, stride 1, ``k // 2`` padding, no bias: mmcv's
    ``weight`` (O, C, k, k) and ``conv_offset`` (a biased k x k conv to
    2 k^2 offsets, (dy, dx) a tap, taps in row-major order)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_offset = nn.Conv2d(in_channels, 2 * kernel_size ** 2, kernel_size,
                                     padding=kernel_size // 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, pad = self.kernel_size, self.kernel_size // 2
        b, c, h, w = x.shape
        offsets = self.conv_offset(x)
        ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(h, w)
        xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(h, w)
        cols = []
        for kh in range(k):
            for kw in range(k):
                t = kh * k + kw
                cols.append(_bilinear_gather(x, ys + (kh - pad) + offsets[:, 2 * t],
                                             xs + (kw - pad) + offsets[:, 2 * t + 1]))
        cols = torch.stack(cols, dim=2).reshape(b, c * k * k, h * w)  # (c, tap) rows
        out = self.weight.reshape(self.weight.shape[0], c * k * k) @ cols
        return out.reshape(b, -1, h, w)
