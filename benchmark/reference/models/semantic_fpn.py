"""SemanticFPNWrapper: P2..P5 fused into one stride-8 map with three 1x1
branches (localization / semantic / depth); mirrors
``polyphonicformer_tpu/models/semantic_fpn.py``.

  P2 (s4):  conv3x3 stride-2
  P3 (s8):  conv3x3
  P4 (s16): conv3x3 -> up2x -> conv3x3
  P5 (s32): (+PE) conv3x3 -> up2x -> conv3x3 -> up2x -> conv3x3
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import resize_bilinear_matmul
from .layers import ConvNormAct, sine_positional_encoding

_TOWER = {0: 1, 1: 1, 2: 2, 3: 3}  # convs per level


class SemanticFPNWrapper(nn.Module):
    def __init__(self, in_channels: int = 256, channels: int = 256,
                 gn_groups: int = 32, num_aux_convs: int = 2):
        super().__init__()
        self.channels = channels
        self.convs_all_levels = nn.ModuleList()
        for lvl, n in _TOWER.items():
            self.convs_all_levels.append(nn.ModuleDict({
                f"conv{j}": ConvNormAct(in_channels if j == 0 else channels, channels, 3,
                                        stride=2 if lvl == 0 else 1, gn_groups=gn_groups)
                for j in range(n)}))
        self.conv_pred = ConvNormAct(channels, channels, 1, gn_groups=gn_groups)
        self.aux_convs = nn.ModuleList(
            ConvNormAct(channels, channels, 1, gn_groups=gn_groups)
            for _ in range(num_aux_convs))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        p2, p3, p4, p5 = feats
        lv = self.convs_all_levels

        def up(t):
            return resize_bilinear_matmul(t, (t.shape[-2] * 2, t.shape[-1] * 2))

        t0 = lv[0]["conv0"](p2)
        t1 = lv[1]["conv0"](p3)
        t2 = lv[2]["conv1"](up(lv[2]["conv0"](p4)))
        pe = sine_positional_encoding(p5.shape[-2], p5.shape[-1], self.channels // 2,
                                      dtype=p5.dtype, device=p5.device)
        t3 = lv[3]["conv0"](p5 + pe.permute(2, 0, 1)[None])
        t3 = lv[3]["conv1"](up(t3))
        t3 = lv[3]["conv2"](up(t3))
        fused = t0 + t1 + t2 + t3
        return (self.conv_pred(fused), *(conv(fused) for conv in self.aux_convs))
