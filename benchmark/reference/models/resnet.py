"""ResNet-50 backbone ('pytorch' style: stride on the 3x3 conv), NCHW,
frozen BN; mirrors ``polyphonicformer_tpu/models/resnet.py``."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import FrozenBatchNorm

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False),
            FrozenBatchNorm(out)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(self, depth: str = "resnet50"):
        super().__init__()
        self.out_channels = (256, 512, 1024, 2048)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        for i, blocks in enumerate(STAGE_BLOCKS[depth]):
            stride = 1 if i == 0 else 2
            layer = nn.Sequential(*[
                Bottleneck(inplanes if b == 0 else planes * 4, planes,
                           stride if b == 0 else 1, downsample=b == 0)
                for b in range(blocks)])
            self.add_module(f"layer{i + 1}", layer)
            inplanes, planes = planes * 4, planes * 2

    def freeze(self, frozen_stages: int) -> None:
        """mmdet ``frozen_stages``: the stem and the first ``frozen_stages``
        stages take no gradient (JAX ``train/optim.py::is_frozen``)."""
        mods = [self.conv1, self.bn1] + [getattr(self, f"layer{i}")
                                         for i in range(1, frozen_stages + 1)]
        for mod in mods:
            mod.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: (B, 3, H, W) normalized. Returns C2..C5 (strides 4/8/16/32)."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        outs = []
        for i in range(4):
            y = getattr(self, f"layer{i + 1}")(y)
            outs.append(y)
        return tuple(outs)
