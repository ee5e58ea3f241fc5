"""STDC backbones (STDCNet813, STDCNet1446), NCHW, frozen BN; mirrors
``polyphonicformer_tpu/models/stdc.py`` (reference
polyphonic/funcs/semantic_fpn.py:412-709: ConvX = conv + BN + ReLU, Cat and
Add bottlenecks halving their channels branch by branch, stems at strides 2
and 4, stages at 8, 16 and 32).

The reference registers the nets but ships no config or checkpoint for
them, so their state-dict keys are the port's own, after the JAX flax paths
(``stem0.conv``, ``stage0_0.conv1.bn``, ``stage0_0.avd_conv``...).  None of
them is ``conv1``, ``bn1`` or ``layer{s}``, so nothing is frozen, as in
JAX (``train/optim.py::is_frozen``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs import STDC_LAYERS
from .layers import FrozenBatchNorm


class ConvX(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, padding=kernel // 2,
                              bias=False)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _depthwise(channels: int) -> nn.Conv2d:
    """The stride-2 3x3 depthwise conv (JAX ``feature_group_count=C``)."""
    return nn.Conv2d(channels, channels, 3, 2, padding=1, groups=channels, bias=False)


def _block_channels(out_planes: int, block_num: int) -> Sequence[int]:
    chans = []
    for idx in range(block_num):
        if idx == 0:
            chans.append(out_planes // 2)
        elif idx == 1 and block_num == 2:
            chans.append(out_planes // 2)
        elif idx == 1 and block_num > 2:
            chans.append(out_planes // 4)
        elif idx < block_num - 1:
            chans.append(out_planes // int(math.pow(2, idx + 1)))
        else:
            chans.append(out_planes // int(math.pow(2, idx)))
    return chans


class CatBottleneck(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, block_num: int = 4, stride: int = 1):
        super().__init__()
        chans = _block_channels(out_planes, block_num)
        self.stride = stride
        self.conv0 = ConvX(in_planes, chans[0], kernel=1)
        if stride == 2:  # the "avd" layer on the first branch
            self.avd_conv = _depthwise(chans[0])
            self.avd_bn = FrozenBatchNorm(chans[0])
        for idx, ch in enumerate(chans[1:]):
            self.add_module(f"conv{idx + 1}", ConvX(chans[idx], ch))
        self.num = len(chans) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv0(x)
        out, outs = out1, []
        for idx in range(self.num):
            if idx == 0 and self.stride == 2:
                out = self.avd_bn(self.avd_conv(out))
            out = getattr(self, f"conv{idx + 1}")(out)
            outs.append(out)
        if self.stride == 2:  # flax avg_pool counts the padded zeros
            out1 = F.avg_pool2d(out1, 3, 2, padding=1, count_include_pad=True)
        return torch.cat([out1] + outs, dim=1)


class AddBottleneck(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, block_num: int = 4, stride: int = 1):
        super().__init__()
        chans = _block_channels(out_planes, block_num)
        self.stride = stride
        ins = [in_planes] + list(chans[:-1])
        for idx, ch in enumerate(chans):
            self.add_module(f"conv{idx}", ConvX(ins[idx], ch, kernel=1 if idx == 0 else 3))
        if stride == 2:
            self.avd_conv = _depthwise(chans[0])
            self.avd_bn = FrozenBatchNorm(chans[0])
            self.skip_dw = _depthwise(in_planes)
            self.skip_dw_bn = FrozenBatchNorm(in_planes)
            self.skip_pw = nn.Conv2d(in_planes, out_planes, 1, bias=False)
            self.skip_pw_bn = FrozenBatchNorm(out_planes)
        self.num = len(chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, outs = x, []
        for idx in range(self.num):
            out = getattr(self, f"conv{idx}")(out)
            if idx == 0 and self.stride == 2:
                out = self.avd_bn(self.avd_conv(out))
            outs.append(out)
        skip = x
        if self.stride == 2:
            skip = self.skip_pw_bn(self.skip_pw(self.skip_dw_bn(self.skip_dw(x))))
        return torch.cat(outs, dim=1) + skip


class STDCNet(nn.Module):
    """layers=(2, 2, 2): STDCNet813; (4, 5, 3): STDCNet1446."""

    def __init__(self, base: int = 64, layers: Tuple[int, ...] = (2, 2, 2),
                 block_num: int = 4, block_type: str = "cat"):
        super().__init__()
        block = CatBottleneck if block_type == "cat" else AddBottleneck
        self.stem0 = ConvX(3, base // 2, stride=2)
        self.stem1 = ConvX(base // 2, base, stride=2)
        self.stages = []
        in_planes = base
        for i, num in enumerate(layers):
            out_planes = base * int(math.pow(2, i + 2))
            names = []
            for j in range(num):
                self.add_module(f"stage{i}_{j}", block(in_planes, out_planes, block_num,
                                                       stride=2 if j == 0 else 1))
                names.append(f"stage{i}_{j}")
                in_planes = out_planes
            self.stages.append(names)
        self.out_channels = (base, 4 * base, 8 * base, 16 * base)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: (B, 3, H, W) normalized.  Returns the maps at strides 4, 8, 16
        and 32."""
        y = self.stem1(self.stem0(x))
        feats = [y]
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return tuple(feats)


def stdcnet813(**kw) -> STDCNet:
    return STDCNet(layers=STDC_LAYERS["stdc813"], **kw)


def stdcnet1446(**kw) -> STDCNet:
    return STDCNet(layers=STDC_LAYERS["stdc1446"], **kw)
