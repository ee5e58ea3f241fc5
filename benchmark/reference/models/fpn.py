"""Feature Pyramid Network (4 levels, nearest top-down), NCHW; mirrors
``polyphonicformer_tpu/models/fpn.py``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import upsample2x_nearest
from .layers import ConvNormAct


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvNormAct(c, out_channels, 1, act=False) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvNormAct(out_channels, out_channels, 3, act=False) for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample2x_nearest(laterals[i])
        return tuple(conv(x) for conv, x in zip(self.fpn_convs, laterals))
