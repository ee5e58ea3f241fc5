"""PolyphonicFormer: backbone (ResNet or Swin) -> FPN -> KernelHead ->
KernelUpdateHead stages, plus the track head.

Images enter as (B, H, W, 3); everything inside is NCHW.  ``state_dict()``
keys are the published mmdet checkpoint's keys, so the reference loads the
same state dict the benchmark hands the program.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .fpn import FPN
from .kernel_head import KernelHead, RPNOutput
from .kernel_update_head import KernelUpdateHead, StageOutput
from .resnet import ResNet
from .swin import SwinTransformer

# backbone -> (embed dim, blocks per stage, heads per stage)
SWIN_SPECS = {"swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
              "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48))}
from .track_head import TrackHead


class ModelOutput(NamedTuple):
    rpn: RPNOutput
    stages: Tuple[StageOutput, ...]


class _RoIHead(nn.Module):
    """Container that gives the stages the reference's key prefix
    ``roi_head.mask_head.{s}``."""

    def __init__(self, stages: Sequence[nn.Module]):
        super().__init__()
        self.mask_head = nn.ModuleList(stages)


class PolyphonicFormer(nn.Module):
    def __init__(self, cfg):
        """cfg: the model configuration (a ResNet or Swin backbone)."""
        super().__init__()
        self.cfg = cfg
        if cfg.backbone.startswith("resnet"):
            self.backbone = ResNet(cfg.backbone)
            self.backbone.freeze(cfg.frozen_stages)
        elif cfg.backbone in SWIN_SPECS:  # no Swin stage is frozen
            self.backbone = SwinTransformer(*SWIN_SPECS[cfg.backbone])
        else:
            raise ValueError(f"unknown backbone {cfg.backbone}")
        # the backward recomputes the backbone's activations
        self.remat_backbone = cfg.remat_backbone
        self.neck = FPN(self.backbone.out_channels, cfg.fpn_out_channels)
        self.rpn_head = KernelHead(
            cfg.fpn_out_channels, cfg.out_channels, cfg.num_proposals,
            cfg.num_thing_classes, cfg.num_stuff_classes, cfg.sem_fpn_gn_groups,
            cfg.hard_mask_thr, cfg.with_semantic_aspp, cfg.aspp_dilations)
        self.roi_head = _RoIHead([
            KernelUpdateHead(cfg.num_classes, cfg.out_channels, cfg.num_heads,
                             cfg.feedforward_channels, cfg.hard_mask_thr,
                             cfg.num_cls_fcs, cfg.num_mask_fcs)
            for _ in range(cfg.num_stages)])
        self.track_head = TrackHead(cfg.track_head, cfg.fpn_out_channels) \
            if cfg.with_track else None

    def extract_feat(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """img: (B, H, W, 3) normalized.  Returns FPN P2..P5, NCHW."""
        x = img.permute(0, 3, 1, 2)
        if self.remat_backbone and torch.is_grad_enabled():
            return self.neck(checkpoint(self.backbone, x, use_reentrant=False))
        return self.neck(self.backbone(x))

    def forward_heads(self, fpn_feats, with_aspp: bool = True) -> ModelOutput:
        """``with_aspp=False``: no ASPP map (serving never reads it)."""
        rpn = self.rpn_head(fpn_feats, with_aspp)
        proposal_feats, mask_preds = rpn.proposal_feats, rpn.mask_preds
        depth_proposal = rpn.depth_proposal
        stages = []
        for head in self.roi_head.mask_head:
            out = head(rpn.x_feats, proposal_feats, mask_preds, depth_proposal,
                       rpn.depth_feats)
            stages.append(out)
            proposal_feats, mask_preds = out.obj_feats, out.mask_preds
            depth_proposal = out.depth_kernels
        return ModelOutput(rpn=rpn, stages=tuple(stages))

    def forward(self, img: torch.Tensor) -> ModelOutput:
        return self.forward_heads(self.extract_feat(img))

    def forward_track_embeds(self, fpn_feats, masks: torch.Tensor | None,
                             mask_valid: torch.Tensor,
                             boxes: torch.Tensor | None = None) -> torch.Tensor:
        """RoIAlign track embeddings (B, M, E) of (padded) instances.

        masks: (B, M, H, W) binary masks at input resolution, or None when
        ``boxes`` is given; mask_valid: (B, M); boxes: optional (B, M, 4)
        RoI boxes, which skip the mask-to-box reduction."""
        return self.track_head(fpn_feats, masks, mask_valid, boxes)


def build_model(cfg, state_dict, device) -> PolyphonicFormer:
    """A model on ``device`` in eval mode holding ``state_dict`` (loaded
    strictly); the parameters of the frozen backbone stages have
    ``requires_grad=False``."""
    with torch.device("meta"):
        model = PolyphonicFormer(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()
