"""ASPP auxiliary semantic neck (the reference's ``semantic_out_cfg`` head);
mirrors ``polyphonicformer_tpu/models/aspp.py``, NCHW.

DeepLab-v3 atrous spatial pyramid pooling: a 1x1 branch and a dilated 3x3
branch per further dilation, each conv + GroupNorm + ReLU, a global-pool
branch (mean, 1x1 conv, GroupNorm, ReLU) broadcast back to h x w, all
concatenated in that order and projected back to ``channels``.  Its map
feeds ``loss_aspp_semseg`` only; serving never reads it.

The reference's mmdet module is outside the reference repository, so its
state-dict keys are the port's own, after the JAX flax paths:
``branch{i}_conv``, ``branch{i}_gn``, ``image_pool_conv``,
``image_pool_gn``, ``project_conv``, ``project_gn``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class ASPP(nn.Module):
    def __init__(self, in_channels: int = 256, channels: int = 256,
                 dilations: Sequence[int] = (1, 6, 12, 18), gn_groups: int = 32):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            k = 1 if d == 1 else 3
            # a dilated 3x3 keeps h x w with padding = dilation
            self.add_module(f"branch{i}_conv", nn.Conv2d(
                in_channels, channels, k, padding=0 if d == 1 else d, dilation=d, bias=False))
            self.add_module(f"branch{i}_gn", nn.GroupNorm(gn_groups, channels, eps=1e-5))
        self.image_pool_conv = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.image_pool_gn = nn.GroupNorm(gn_groups, channels, eps=1e-5)
        n = len(self.dilations) + 1
        self.project_conv = nn.Conv2d(n * channels, channels, 1, bias=False)
        self.project_gn = nn.GroupNorm(gn_groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [F.relu(getattr(self, f"branch{i}_gn")(getattr(self, f"branch{i}_conv")(x)))
                    for i in range(len(self.dilations))]
        g = F.relu(self.image_pool_gn(self.image_pool_conv(x.mean(dim=(2, 3), keepdim=True))))
        branches.append(g.expand(-1, -1, *x.shape[2:]))
        return F.relu(self.project_gn(self.project_conv(torch.cat(branches, dim=1))))
