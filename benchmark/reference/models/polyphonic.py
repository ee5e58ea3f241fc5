"""PolyphonicFormer: backbone -> neck -> KernelHead -> KernelUpdateHead
stages, plus the track head.

The backbone and its neck come from ``reference/backbones/<backbone>.py``,
found by the configuration's ``backbone`` name: its ``build(cfg) ->
(backbone, neck)`` and optionally ``INIT_STD`` (key suffix -> std of the
seeded draw, ``benchmark/weights.py``).  The neck returns the four levels at strides 4/8/16/32 with ``fpn_out_channels``.

Images enter as (B, H, W, 3); everything inside is NCHW.  ``state_dict()``
keys are the published mmdet checkpoint's keys, so the reference loads the
same state dict the benchmark hands the program.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...cells import module
from .kernel_head import KernelHead, RPNOutput
from .kernel_update_head import KernelUpdateHead, StageOutput
from .track_head import TrackHead

BACKBONES = Path(__file__).resolve().parents[1] / "backbones"


def backbone_file(name: str, root: Path | None = None):
    """The module of ``<name>.py`` in ``root`` (default :data:`BACKBONES`)."""
    path = (BACKBONES if root is None else Path(root)) / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown backbone {name!r}: no file {path}")
    return module(path, f"benchmark.reference.backbones.{name}")


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
        """cfg: the model configuration; its backbone is a file of
        :data:`BACKBONES`."""
        super().__init__()
        self.cfg = cfg
        self.backbone, self.neck = backbone_file(cfg.backbone).build(cfg)
        # the backward recomputes the backbone's activations
        self.remat_backbone = cfg.remat_backbone
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
