"""RoIAlign for track embeddings and boxes from mask marginals, mirroring
``polyphonicformer_tpu/ops/roi_align.py`` (mmcv RoIAlign, output 7,
sampling ratio 2, aligned; mmdet FPN level routing; MAD boxes).

Two RoIAlign forms: the flattened-pyramid gather
(:func:`multilevel_roi_align`) and per-level separable interpolation
matmuls (:func:`multilevel_roi_align_separable`), equal to float
tolerance.  Boxes come from a mask's row and column counts
(:func:`masks_to_boxes_mad`) or, for the training GT, from the exact
counts of the binarised x4 upsample computed at stride 4
(:func:`upsampled_support_marginals`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.nn import functional as F

from .device_tables import device_table
from .resize import _bilinear_matrix


@device_table(maxsize=64)
def _device_const(values: tuple, device: torch.device) -> torch.Tensor:
    """A small per-level table on ``device``, copied there once (a copy from
    host memory would stall the stream on every call)."""
    return torch.tensor(values, device=device)


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` of an (N, C) table, as an embedding lookup: its
    backward sums the rows of a repeated index in parallel segments, where
    the backward of advanced indexing adds them one after another (every
    sample of a padded RoI, a zero box, reads the same corner)."""
    return F.embedding(index, table)


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
    v1 = _rows(flat, off_l + y_low * w_l + x_low)
    v2 = _rows(flat, off_l + y_low * w_l + x_high)
    v3 = _rows(flat, off_l + y_high * w_l + x_low)
    v4 = _rows(flat, off_l + y_high * w_l + x_high)
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


def _interp_axis_matrix(lo: torch.Tensor, hi: torch.Tensor, size: int, scale: float,
                        out_size: int, g: int) -> torch.Tensor:
    """Per-RoI 1-D interpolation matrices (M, out_size, size): ``A @ feat``
    along one axis is RoIAlign's bilinear sampling on that axis, the
    sampling-ratio average folded in, with the boundary semantics of the
    gather (zero outside [-1, size], clamped at the border).  lo, hi: (M,)
    RoI start and end in image coordinates; scale: the level's 1 / stride."""
    dev = lo.device
    a = lo * scale - 0.5
    b = hi * scale - 0.5
    bin_sz = (b - a) / out_size
    bin_idx = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub_idx = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    off = bin_idx[:, None] + sub_idx[None, :]  # (out, g) in bins
    coords = a[:, None, None] + off[None] * bin_sz[:, None, None]  # (M, out, g)
    valid = (coords >= -1.0) & (coords <= size)
    x = torch.clamp(coords, min=0.0)
    x_low = torch.floor(x).long()
    over = x_low >= size - 1
    x_low = torch.where(over, torch.full_like(x_low, size - 1), x_low)
    x = torch.where(over, x_low.float(), x)
    x_high = torch.clamp(x_low + 1, max=size - 1)
    lx = x - x_low
    zero = torch.zeros((), dtype=lx.dtype, device=dev)
    w_low = torch.where(valid, 1.0 - lx, zero)
    w_high = torch.where(valid, lx, zero)
    pos = torch.arange(size, device=dev)  # one-hot by comparison (F.one_hot reads back)
    mat = ((x_low[..., None] == pos).float() * w_low[..., None]
           + (x_high[..., None] == pos).float() * w_high[..., None])
    return mat.mean(dim=2)


def multilevel_roi_align_separable(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                                   strides: Sequence[int] = (4, 8, 16, 32),
                                   out_size: int = 7, sampling_ratio: int = 2,
                                   finest_scale: int = 56) -> torch.Tensor:
    """RoIAlign with FPN routing as separable interpolation matmuls: each
    RoI's grid is ``A_y @ feat @ A_x^T`` per level, the matrices of RoIs
    routed elsewhere zeroed, the levels summed.  feats: per level (H_l,
    W_l, C); rois (M, 4).  Returns (M, out, out, C) in the features' dtype;
    matches :func:`multilevel_roi_align` to float tolerance."""
    dtype = feats[0].dtype
    lvls = map_roi_levels(rois, len(feats), finest_scale)
    out = None
    for lv, (feat, stride) in enumerate(zip(feats, strides)):
        h, w, _ = feat.shape
        sel = (lvls == lv).float()
        ay = _interp_axis_matrix(rois[:, 1], rois[:, 3], h, 1.0 / stride, out_size,
                                 sampling_ratio) * sel[:, None, None]
        ax = _interp_axis_matrix(rois[:, 0], rois[:, 2], w, 1.0 / stride, out_size,
                                 sampling_ratio)
        t = torch.einsum("mxw,hwc->mhxc", ax.to(dtype), feat)  # x first: the smaller product
        r = torch.einsum("myh,mhxc->myxc", ay.to(dtype), t)
        out = r if out is None else out + r
    return out


def masks_to_boxes_mad(masks: torch.Tensor, extend: float = 2.0) -> torch.Tensor:
    """Center +- extend * MAD boxes (M, 4) of (M, H, W) masks (a pixel is
    in the mask where it is > 0), from their row and column counts."""
    mb = masks > 0
    colcount = mb.sum(dim=1).float()  # (M, W)
    rowcount = mb.sum(dim=2).float()  # (M, H)
    return boxes_mad_from_marginals(rowcount, colcount, extend)


@device_table(maxsize=16)
def _support_tables(in_size: int, out_size: int, device: torch.device):
    """Tables for the exact counts of a binarised bilinear upsample, on
    ``device`` (copied once).  The align_corners=False matrix A (out, in)
    has at most 2 positive taps a row, adjacent (a, a+1), or one clamped:

    S (out, in): A > 0; T (out, in-1): rows whose taps are exactly
    {a, a+1}; n1 (in,) = S.sum(0), the rows touching tap a; n2 (in-1,) =
    T.sum(0), the rows with the pair {a, a+1}."""
    a = _bilinear_matrix(in_size, out_size) > 0
    s = a.astype(np.float32)
    t = (a[:, :-1] & a[:, 1:]).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (s, t, s.sum(0), t.sum(0)))


def upsampled_support_marginals(masks: torch.Tensor, out_hw) -> tuple:
    """Exact row and column counts, (M, H) and (M, W) f32, of the binarised
    upsample ``resize_bilinear(masks, out_hw) > 0`` of (M, h, w) masks,
    without the (M, H, W) volume.

    An output pixel is in the support iff one of its <= 2x2 positive taps
    hits a source pixel > 0.  With d the support dilated along y (S_h over
    the rows, thresholded), inclusion-exclusion over the adjacent x taps
    (a OR b = a + b - ab) gives the counts as small contractions of 0/1
    values and small integers, exact in f32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = masks.shape[-2:]
    s_h, _, _, _ = _support_tables(h, out_h, masks.device)
    s_w, t_w, n1, n2 = _support_tables(w, out_w, masks.device)
    mb = (masks > 0).float()
    d = (torch.einsum("Oh,mhw->mOw", s_h, mb) > 0).float()  # (M, H, w)
    dpair = d[:, :, :-1] * d[:, :, 1:]  # (M, H, w-1) adjacent AND
    rowcount = d @ n1 - dpair @ n2  # (M, H)
    colcount = d.sum(dim=1) @ s_w.T - dpair.sum(dim=1) @ t_w.T  # (M, W)
    return rowcount, colcount
