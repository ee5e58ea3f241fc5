"""Flow-aligned localization neck: ``UperNetAlignHead`` over
``AlignedModule`` (v1) or ``AlignedModuleV2PoolingAtten`` (v2), NCHW;
mirrors ``polyphonicformer_tpu/models/aligned_fpn.py`` (reference
polyphonic/funcs/semantic_fpn.py:238-409): a top-down FPN whose upsampling
is a learned flow-field warp (v1) or a gated pair of warps (v2), the levels
fused at stride 8, a sine positional encoding added and a deformable conv
to finish.  Registered in the reference, built by no model path there or in
the JAX package; it stands alone, as the JAX tests run it.

As in the JAX package, the top level is first projected to ``out_channels``
(the reference adds the raw 2048-channel top level, which cannot
type-check).  Module names are the JAX flax names.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.deform_conv import DeformConv2d
from ..ops.grid_sample import flow_warp
from ..ops.resize import resize_bilinear_matmul
from .layers import FrozenBatchNorm, sine_positional_encoding


class AlignedModule(nn.Module):
    def __init__(self, inplane: int, outplane: int):
        super().__init__()
        self.down_l = nn.Conv2d(inplane, outplane, 1, bias=False)
        self.down_h = nn.Conv2d(inplane, outplane, 1, bias=False)
        self.flow_make = nn.Conv2d(2 * outplane, 2, 3, padding=1, bias=False)

    def forward(self, low_feature: torch.Tensor, h_feature: torch.Tensor) -> torch.Tensor:
        """low_feature: (B, C, 2H, 2W), the finer level; h_feature: (B, C,
        H, W).  Returns h_feature warped to the finer level's size."""
        size = low_feature.shape[-2:]
        low = self.down_l(low_feature)
        hi = resize_bilinear_matmul(self.down_h(h_feature), size)
        flow = self.flow_make(torch.cat([hi, low], dim=1))
        return flow_warp(h_feature, flow, size)


class AlignedModuleV2PoolingAtten(nn.Module):
    def __init__(self, inplane: int, outplane: int):
        super().__init__()
        self.down_l = nn.Conv2d(inplane, outplane, 1, bias=False)
        self.down_h = nn.Conv2d(inplane, outplane, 1, bias=False)
        self.flow_make = nn.Conv2d(2 * outplane, 4, 3, padding=1, bias=False)
        self.flow_gate = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, low_feature: torch.Tensor, h_feature: torch.Tensor) -> torch.Tensor:
        size = low_feature.shape[-2:]
        low = self.down_l(low_feature)
        hi = resize_bilinear_matmul(self.down_h(h_feature), size)
        flow = self.flow_make(torch.cat([hi, low], dim=1))
        h_warp = flow_warp(h_feature, flow[:, :2], size)
        l_warp = flow_warp(low_feature, flow[:, 2:], size)
        stats = torch.cat([hi.mean(dim=1, keepdim=True), low_feature.mean(dim=1, keepdim=True),
                           hi.amax(dim=1, keepdim=True),
                           low_feature.amax(dim=1, keepdim=True)], dim=1)
        gate = torch.sigmoid(self.flow_gate(stats))
        return h_warp * gate + l_warp * (1.0 - gate)


class UperNetAlignHead(nn.Module):
    """An alternative localization neck: one fused stride-8 map from the
    four levels ``conv_out`` (strides 4 to 32)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 align_type: str = "v1", pe_num_feats: int = 0):
        super().__init__()
        n = len(in_channels)
        self.n = n
        self.pe_num_feats = pe_num_feats or out_channels // 2
        self.fpn_in_top = nn.Conv2d(in_channels[-1], out_channels, 1)
        self.fpn_in_top_bn = FrozenBatchNorm(out_channels)
        align = AlignedModule if align_type == "v1" else AlignedModuleV2PoolingAtten
        for i in reversed(range(n - 1)):
            self.add_module(f"fpn_in_{i}", nn.Conv2d(in_channels[i], out_channels, 1))
            self.add_module(f"fpn_in_bn_{i}", FrozenBatchNorm(out_channels))
            self.add_module(f"align_{i}", align(out_channels, out_channels // 2))
            self.add_module(f"fpn_out_{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))
            self.add_module(f"fpn_out_bn_{i}", FrozenBatchNorm(out_channels))
        self.dcn = DeformConv2d(out_channels, out_channels)

    def forward(self, conv_out: Sequence[torch.Tensor]) -> torch.Tensor:
        f = F.relu(self.fpn_in_top_bn(self.fpn_in_top(conv_out[-1])))
        feats = [f]
        for i in reversed(range(self.n - 1)):
            cx = F.relu(getattr(self, f"fpn_in_bn_{i}")(getattr(self, f"fpn_in_{i}")(conv_out[i])))
            f = cx + getattr(self, f"align_{i}")(cx, f)
            y = getattr(self, f"fpn_out_bn_{i}")(getattr(self, f"fpn_out_{i}")(f))
            feats.append(F.relu(y))
        size = conv_out[1].shape[-2:]
        fused = sum(resize_bilinear_matmul(t, size) for t in feats)
        pe = sine_positional_encoding(size[0], size[1], num_feats=self.pe_num_feats,
                                      dtype=fused.dtype, device=fused.device)
        return self.dcn(fused + pe.permute(2, 0, 1)[None])
