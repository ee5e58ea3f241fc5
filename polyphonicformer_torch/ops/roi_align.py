"""RoIAlign for track embeddings and boxes from mask marginals, mirroring
``polyphonicformer_tpu/ops/roi_align.py`` (mmcv RoIAlign, output 7,
sampling ratio 2, aligned; mmdet FPN level routing; MAD boxes).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch


@functools.lru_cache(maxsize=64)
def _device_const(values: tuple, device: torch.device) -> torch.Tensor:
    """A small per-level table on ``device``, copied there once (a copy from
    host memory would stall the stream on every call)."""
    return torch.tensor(values, device=device)


def map_roi_levels(rois: torch.Tensor, num_levels: int = 4,
                   finest_scale: int = 56) -> torch.Tensor:
    """mmdet FPN level routing: floor(log2(sqrt(area) / finest + 1e-6))."""
    scale = torch.sqrt(torch.clamp(
        (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]), min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int] = (4, 8, 16, 32),
                         out_size: int = 7, sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """RoIAlign with FPN routing, the flattened-pyramid gather.

    feats: per level (H_l, W_l, C); rois: (M, 4) x1, y1, x2, y2 in image
    coordinates.  Returns (M, out, out, C) in the features' dtype.
    """
    num_levels = len(feats)
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    dev = rois.device
    lvls = map_roi_levels(rois, num_levels, finest_scale)  # (M,)
    sizes = [f.shape[0] * f.shape[1] for f in feats]
    hs = _device_const(tuple(f.shape[0] for f in feats), dev)
    ws = _device_const(tuple(f.shape[1] for f in feats), dev)
    offs = _device_const(tuple(sum(sizes[:i]) for i in range(num_levels)), dev)
    scales = _device_const(tuple(1.0 / s for s in strides), dev)
    flat = torch.cat([f.reshape(-1, c) for f in feats], dim=0)

    m = rois.shape[0]
    sc = scales[lvls]
    h_l, w_l, off_l = hs[lvls][:, None], ws[lvls][:, None], offs[lvls][:, None]
    x1 = rois[:, 0] * sc - 0.5
    y1 = rois[:, 1] * sc - 0.5
    x2 = rois[:, 2] * sc - 0.5
    y2 = rois[:, 3] * sc - 0.5
    g = sampling_ratio
    bin_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub_idx = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    off = bin_idx[:, None] + sub_idx[None, :]  # (out, g) in bins
    ys = y1[:, None, None] + off[None] * ((y2 - y1) / out_size)[:, None, None]
    xs = x1[:, None, None] + off[None] * ((x2 - x1) / out_size)[:, None, None]
    yy = ys[:, :, :, None, None].expand(m, out_size, g, out_size, g).reshape(m, -1)
    xx = xs[:, None, None, :, :].expand(m, out_size, g, out_size, g).reshape(m, -1)

    hf, wf = h_l.float(), w_l.float()
    valid = (yy >= -1.0) & (yy <= hf) & (xx >= -1.0) & (xx <= wf)
    y = torch.clamp(yy, min=0.0)
    x = torch.clamp(xx, min=0.0)
    y_low = torch.floor(y).long()
    x_low = torch.floor(x).long()
    over_y = y_low >= h_l - 1
    over_x = x_low >= w_l - 1
    y_low = torch.where(over_y, h_l - 1, y_low)
    x_low = torch.where(over_x, w_l - 1, x_low)
    y = torch.where(over_y, y_low.float(), y)
    x = torch.where(over_x, x_low.float(), x)
    y_high = torch.clamp(y_low + 1, max=h_l - 1)
    x_high = torch.clamp(x_low + 1, max=w_l - 1)
    ly = (y - y_low).to(dtype)
    lx = (x - x_low).to(dtype)
    hy, hx = 1.0 - ly, 1.0 - lx
    v1 = flat[off_l + y_low * w_l + x_low]
    v2 = flat[off_l + y_low * w_l + x_high]
    v3 = flat[off_l + y_high * w_l + x_low]
    v4 = flat[off_l + y_high * w_l + x_high]
    out = (hy * hx)[..., None] * v1 + (hy * lx)[..., None] * v2 \
        + (ly * hx)[..., None] * v3 + (ly * lx)[..., None] * v4
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))
    return out.reshape(m, out_size, g, out_size, g, c).mean(dim=(2, 4))


def boxes_mad_from_marginals(rowcount: torch.Tensor, colcount: torch.Tensor,
                             extend: float = 2.0) -> torch.Tensor:
    """Center +- extend * mean-absolute-deviation boxes (M, 4) x1, y1, x2, y2
    from (M, H) row and (M, W) column counts; empty masks give zeros."""
    h, w = rowcount.shape[1], colcount.shape[1]
    dev = rowcount.device
    area = colcount.sum(dim=1)
    safe_area = torch.clamp(area, min=1.0)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None]
    cy = (rowcount * ys).sum(dim=1) / safe_area
    cx = (colcount * xs).sum(dim=1) / safe_area
    dy = torch.clamp((rowcount * (ys - cy[:, None]).abs()).sum(dim=1) / safe_area, min=1.0)
    dx = torch.clamp((colcount * (xs - cx[:, None]).abs()).sum(dim=1) / safe_area, min=1.0)
    boxes = torch.stack([cx - dx * extend, cy - dy * extend,
                         cx + dx * extend, cy + dy * extend], dim=1)
    boxes = torch.where(area[:, None] > 0, boxes, torch.zeros_like(boxes))
    return torch.clamp(boxes, min=0.0)
