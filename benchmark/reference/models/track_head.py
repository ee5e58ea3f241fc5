"""Quasi-dense track-embedding head fed by RoIAlign boxes (given, or the
MAD boxes of masks); mirrors
``polyphonicformer_tpu/models/track_head.py``.  The 7x7 RoI features are
NCHW and flatten C-major, as the reference's ``track_head.fcs.0`` expects."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.roi_align import (masks_to_boxes_mad, multilevel_roi_align,
                             multilevel_roi_align_separable)
from .layers import ConvNormAct


class TrackHead(nn.Module):
    def __init__(self, cfg, in_channels: int):
        """cfg: a ``TrackHeadConfig``; in_channels: FPN width."""
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(
            ConvNormAct(in_channels if i == 0 else cfg.conv_out_channels,
                        cfg.conv_out_channels, 3, gn_groups=cfg.gn_groups)
            for i in range(cfg.num_convs))
        k = cfg.roi_feat_size
        self.fcs = nn.ModuleList(
            nn.Linear(cfg.conv_out_channels * k * k if i == 0 else cfg.fc_out_channels,
                      cfg.fc_out_channels)
            for i in range(cfg.num_fcs))
        self.fc_embed = nn.Linear(cfg.fc_out_channels, cfg.embed_channels)

    def embed(self, rois: torch.Tensor) -> torch.Tensor:
        """(M, C, 7, 7) RoI features -> (M, E) embeddings."""
        x = rois
        for conv in self.convs:
            x = conv(x)
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_embed(x)

    def forward(self, fpn_feats: Sequence[torch.Tensor], masks: torch.Tensor | None,
                mask_valid: torch.Tensor, boxes: torch.Tensor | None = None) -> torch.Tensor:
        """fpn_feats: P2..P5 (B, C, H_l, W_l); masks: (B, M, H, W) at input
        resolution, None when ``boxes`` is given; mask_valid: (B, M);
        boxes: (B, M, 4) x1, y1, x2, y2 MAD boxes, or None to compute them
        from ``masks``.  Returns (B, M, E)."""
        cfg = self.cfg
        roi_align = (multilevel_roi_align_separable if cfg.roi_impl == "separable"
                     else multilevel_roi_align)
        rois = []
        for b in range(mask_valid.shape[0]):
            bxs = masks_to_boxes_mad(masks[b]) if boxes is None else boxes[b]
            bxs = torch.where(mask_valid[b][:, None], bxs, torch.zeros_like(bxs))
            rois.append(roi_align(
                [f[b].permute(1, 2, 0) for f in fpn_feats], bxs,
                strides=cfg.featmap_strides, out_size=cfg.roi_feat_size,
                sampling_ratio=cfg.roi_sampling_ratio, finest_scale=cfg.finest_scale))
        rois = torch.stack(rois)  # (B, M, 7, 7, C)
        b, m = rois.shape[:2]
        embeds = self.embed(rois.flatten(0, 1).permute(0, 3, 1, 2)).reshape(b, m, -1)
        return embeds * mask_valid[..., None].to(embeds.dtype)
