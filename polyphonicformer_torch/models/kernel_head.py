"""KernelHead: stage-0 proposal generator (thing / stuff / depth branches);
mirrors ``polyphonicformer_tpu/models/kernel_head.py``.

The learned query kernels and the stuff and depth 1x1 convs are bias-free or
biased ``nn.Conv2d``s as in the reference, whose weights double as query
initialisations.  With ``with_semantic_aspp`` the head also runs the ASPP
auxiliary semantic neck on ``x_feats`` and a 1x1 conv to the classes
(``aspp_seg_preds``), for ``loss_aspp_semseg``."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.cuda.mask_pool import masked_pool
from .aspp import ASPP
from .layers import ConvNormAct
from .semantic_fpn import SemanticFPNWrapper


class RPNOutput(NamedTuple):
    proposal_feats: torch.Tensor  # (B, N, C) kernels incl. stuff
    x_feats: torch.Tensor  # (B, C, h, w) fused loc + sem features (stride 8)
    mask_preds: torch.Tensor  # (B, N, h, w) logits incl. stuff rows
    mask_preds_things: torch.Tensor  # (B, num_proposals, h, w)
    seg_preds: torch.Tensor  # (B, num_classes, h, w) dense semantic logits
    depth_feats: torch.Tensor  # (B, C, h, w) depth branch features
    depth_proposal: torch.Tensor  # (B, N, C) depth kernels
    depth_pred: torch.Tensor  # (B, h, w) dense depth logits
    # (B, num_classes, h, w) ASPP semantic logits; None without the ASPP head
    # or when the caller asks the forward not to compute them
    aspp_seg_preds: torch.Tensor | None = None


class KernelHead(nn.Module):
    def __init__(self, in_channels: int = 256, channels: int = 256,
                 num_proposals: int = 100, num_thing_classes: int = 8,
                 num_stuff_classes: int = 11, gn_groups: int = 32,
                 hard_mask_thr: float = 0.5, with_semantic_aspp: bool = False,
                 aspp_dilations: Sequence[int] = (1, 6, 12, 18)):
        super().__init__()
        self.num_thing_classes = num_thing_classes
        self.num_stuff_classes = num_stuff_classes
        self.hard_mask_thr = hard_mask_thr
        num_classes = num_thing_classes + num_stuff_classes
        self.localization_fpn = SemanticFPNWrapper(in_channels, channels, gn_groups)
        self.loc_convs = nn.ModuleList([ConvNormAct(channels, channels, 1, gn_groups=gn_groups)])
        self.seg_convs = nn.ModuleList([ConvNormAct(channels, channels, 1, gn_groups=gn_groups)])
        self.depth_convs = nn.ModuleList([ConvNormAct(channels, channels, 1, gn_groups=gn_groups)])
        self.init_kernels = nn.Conv2d(channels, num_proposals, 1, bias=False)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.conv_direct_depth = nn.Conv2d(channels, 1, 1)
        if with_semantic_aspp:
            self.semantic_aspp = ASPP(channels, channels, aspp_dilations, gn_groups)
            self.semantic_aspp_predict = nn.Conv2d(channels, num_classes, 1)
        else:
            self.semantic_aspp = self.semantic_aspp_predict = None

    def forward(self, fpn_feats: Sequence[torch.Tensor], with_aspp: bool = True) -> RPNOutput:
        """``with_aspp=False`` skips the ASPP map: serving never reads it
        (the JAX package's jitted serving steps drop it as dead code)."""
        loc, sem, dep = self.localization_fpn(fpn_feats)
        loc_feats = self.loc_convs[0](loc)
        semantic_feats = self.seg_convs[0](sem)
        depth_feats = self.depth_convs[0](dep)
        b = loc_feats.shape[0]

        init_kernels = self.init_kernels.weight[:, :, 0, 0]  # (N, C)
        # contiguous for K1: at batch > 1 the einsum returns a permuted view
        mask_preds_things = torch.einsum("bchw,nc->bnhw", loc_feats, init_kernels).contiguous()
        conv_seg_w = self.conv_seg.weight[:, :, 0, 0]
        seg_preds = torch.einsum("bchw,nc->bnhw", semantic_feats, conv_seg_w) \
            + self.conv_seg.bias[:, None, None]
        conv_depth_w = self.conv_direct_depth.weight[:, :, 0, 0]  # (1, C)
        depth_pred = (torch.einsum("bchw,nc->bnhw", depth_feats, conv_depth_w)
                      + self.conv_direct_depth.bias[:, None, None])[:, 0]
        x_feats = semantic_feats + loc_feats
        aspp_seg_preds = None
        if self.semantic_aspp is not None and with_aspp:
            aspp_seg_preds = torch.einsum(
                "bchw,nc->bnhw", self.semantic_aspp(x_feats),
                self.semantic_aspp_predict.weight[:, :, 0, 0]) \
                + self.semantic_aspp_predict.bias[:, None, None]

        # query init: kernel weights + hard-mask pooled features (K1)
        obj_feats = masked_pool(mask_preds_things, x_feats.permute(0, 2, 3, 1),
                                self.hard_mask_thr).to(x_feats.dtype)
        proposal_feats = init_kernels[None] + obj_feats
        nt = self.num_thing_classes
        mask_preds = torch.cat([mask_preds_things, seg_preds[:, nt:]], dim=1)
        stuff_kernels = conv_seg_w[nt:][None].expand(b, -1, -1)
        proposal_feats = torch.cat([proposal_feats, stuff_kernels], dim=1)
        depth_proposal = conv_depth_w[None].expand(b, proposal_feats.shape[1], -1)
        return RPNOutput(proposal_feats=proposal_feats, x_feats=x_feats,
                         mask_preds=mask_preds, mask_preds_things=mask_preds_things,
                         seg_preds=seg_preds, depth_feats=depth_feats,
                         depth_proposal=depth_proposal, depth_pred=depth_pred,
                         aspp_seg_preds=aspp_seg_preds)
