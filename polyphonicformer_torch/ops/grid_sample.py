"""Bilinear grid sampling and flow warping (align_corners=True, zero
padding), NCHW; mirrors ``polyphonicformer_tpu/ops/grid_sample.py``, which
writes ``F.grid_sample``'s semantics as XLA gathers (the reference calls
``F.grid_sample``, polyphonic/funcs/semantic_fpn.py:333-354).  Used by the
flow-aligned FPN (``models/aligned_fpn.py``)."""
from __future__ import annotations

import torch
from torch.nn import functional as F


def grid_sample_bilinear(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat: (B, C, H, W); grid: (B, Ho, Wo, 2) normalised (x, y) in [-1, 1]
    (align_corners=True).  Taps outside the map contribute zero.  Returns
    (B, C, Ho, Wo)."""
    return F.grid_sample(feat, grid.to(feat.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def flow_warp(feat: torch.Tensor, flow: torch.Tensor, out_hw) -> torch.Tensor:
    """Warp feat (B, C, H, W) by a pixel-space flow (B, 2, Ho, Wo), (x, y)
    channels, as the reference's ``flow_warp``: grid = base grid + flow /
    (Wo, Ho)."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    dev = feat.device
    ys = torch.linspace(-1.0, 1.0, out_h, device=dev)
    xs = torch.linspace(-1.0, 1.0, out_w, device=dev)
    base = torch.stack([xs[None, :].expand(out_h, out_w), ys[:, None].expand(out_h, out_w)],
                       dim=-1)  # (Ho, Wo, 2)
    norm = torch.tensor([out_w, out_h], dtype=feat.dtype, device=dev)
    grid = base[None].to(feat.dtype) + flow.permute(0, 2, 3, 1) / norm
    return grid_sample_bilinear(feat, grid)
