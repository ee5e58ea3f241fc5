"""One kernel-update refinement stage: dual mask / depth kernel update,
query attention and the dynamic 1x1 convolution; mirrors
``polyphonicformer_tpu/models/kernel_update_head.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels import masked_pool
from .kernel_updator import KernelUpdator
from .layers import FFN, ConvNormAct, MultiheadSelfAttention


class StageOutput(NamedTuple):
    cls_score: torch.Tensor  # (B, N, num_classes) logits
    mask_preds: torch.Tensor  # (B, N, h, w) logits at stride 8
    obj_feats: torch.Tensor  # (B, N, C) updated mask kernels
    depth_preds: torch.Tensor  # (B, N, h, w) raw depth logits at stride 8
    depth_kernels: torch.Tensor  # (B, N, C) updated depth kernels


class KernelUpdateHead(nn.Module):
    def __init__(self, num_classes: int = 19, channels: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 2048, hard_mask_thr: float = 0.5,
                 num_cls_fcs: int = 1, num_mask_fcs: int = 1):
        super().__init__()
        c = channels
        self.hard_mask_thr = hard_mask_thr
        self.feat_transform = ConvNormAct(c, c, 1, act=False)
        self.feat_depth_transform = ConvNormAct(c, c, 1, act=False)
        self.kernel_update_conv = KernelUpdator(c)
        self.kernel_update_conv_depth = KernelUpdator(c)
        self.attention = MultiheadSelfAttention(c, num_heads)
        self.attention_norm = nn.LayerNorm(c, eps=1e-5)
        self.attention_depth = MultiheadSelfAttention(c, num_heads)
        self.attention_norm_depth = nn.LayerNorm(c, eps=1e-5)
        self.ffn = FFN(c, feedforward_channels)
        self.ffn_norm = nn.LayerNorm(c, eps=1e-5)
        self.ffn_depth = FFN(c, feedforward_channels)
        self.ffn_norm_depth = nn.LayerNorm(c, eps=1e-5)
        # the reference interleaves [Linear, LN, ReLU] (depth: [Linear, LN])
        self.cls_fcs = nn.ModuleList()
        for _ in range(num_cls_fcs):
            self.cls_fcs.extend([nn.Linear(c, c, bias=False), nn.LayerNorm(c, eps=1e-5), nn.ReLU()])
        self.mask_fcs = nn.ModuleList()
        self.depth_regs = nn.ModuleList()
        for _ in range(num_mask_fcs):
            self.mask_fcs.extend([nn.Linear(c, c, bias=False), nn.LayerNorm(c, eps=1e-5), nn.ReLU()])
            self.depth_regs.extend([nn.Linear(c, c, bias=False), nn.LayerNorm(c, eps=1e-5)])
        self.fc_cls = nn.Linear(c, num_classes)
        self.fc_mask = nn.Linear(c, c)
        self.fc_depth = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, proposal_feat: torch.Tensor,
                mask_preds: torch.Tensor, depth_proposal: torch.Tensor,
                depth_feats: torch.Tensor) -> StageOutput:
        """x, depth_feats: (B, C, h, w); proposal_feat, depth_proposal:
        (B, N, C); mask_preds: (B, N, h, w) at the resolution of x."""
        x = self.feat_transform(x)
        depth_feats = self.feat_depth_transform(depth_feats)

        # hard-mask pooling (K1), twice
        x_feat = masked_pool(mask_preds, x.permute(0, 2, 3, 1),
                             self.hard_mask_thr).to(x.dtype)
        depth_feat_masked = masked_pool(mask_preds, depth_feats.permute(0, 2, 3, 1),
                                        self.hard_mask_thr).to(x.dtype)

        # unified-query coupling: the depth kernel sees the mask kernel
        depth_proposal = depth_proposal + proposal_feat.detach()
        obj_feat = self.kernel_update_conv(x_feat, proposal_feat)
        depth_new = self.kernel_update_conv_depth(depth_feat_masked, depth_proposal)
        obj_feat = self.attention_norm(self.attention(obj_feat))
        depth_new = self.attention_norm_depth(self.attention_depth(depth_new))
        obj_feat = self.ffn_norm(self.ffn(obj_feat))
        depth_new = self.ffn_norm_depth(self.ffn_depth(depth_new))

        cls_feat, mask_feat, depth_reg = obj_feat, obj_feat, depth_new
        for layer in self.cls_fcs:
            cls_feat = layer(cls_feat)
        for layer in self.mask_fcs:
            mask_feat = layer(mask_feat)
        for layer in self.depth_regs:
            depth_reg = layer(depth_reg)
        cls_score = self.fc_cls(cls_feat)
        mask_kernels = self.fc_mask(mask_feat)
        depth_kernels = self.fc_depth(depth_reg)

        # dynamic 1x1 convolution, batched
        new_mask_preds = torch.einsum("bnc,bchw->bnhw", mask_kernels, x)
        new_depth_preds = torch.einsum("bnc,bchw->bnhw", depth_kernels, depth_feats)
        return StageOutput(cls_score=cls_score, mask_preds=new_mask_preds,
                           obj_feats=obj_feat, depth_preds=new_depth_preds,
                           depth_kernels=depth_new)

