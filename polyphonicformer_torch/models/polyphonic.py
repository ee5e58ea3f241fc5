"""PolyphonicFormer: backbone -> FPN -> KernelHead -> KernelUpdateHead
stages, plus the track head; mirrors
``polyphonicformer_tpu/models/polyphonic.py``.  A ViTDet backbone
(``VIT_SPECS``, the port's own) takes its simple feature pyramid for the
FPN (``models/vit.py``).

Images enter in the JAX layout (B, H, W, 3); everything inside is NCHW.
``state_dict()`` keys are the reference checkpoint's keys
(``polyphonicformer_tpu/tools/convert_torch_ckpt.py::build_param_mapping``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import STDC_LAYERS, SWIN_SPECS, VIT_SPECS
from ..utils.profiling import span
from .fpn import FPN
from .kernel_head import KernelHead, RPNOutput
from .kernel_update_head import KernelUpdateHead, StageOutput
from .resnet import ResNet
from .stdc import STDCNet
from .swin import SwinTransformer
from .track_head import TrackHead
from .vit import SimpleFeaturePyramid, ViT


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
    def __init__(self, cfg, tp=None):
        """cfg: a ``configs.ModelConfig`` (ResNet, Swin, STDC or ViTDet
        backbones).  ``tp``: the mesh's model axis (``parallel.
        tensor_parallel.ModelParallel``) that a Swin backbone with
        ``cfg.shard_backbone`` shards over; ignored otherwise.  A ViT has no
        tensor-parallel form: ``shard_backbone`` raises."""
        super().__init__()
        self.cfg = cfg
        if cfg.backbone.startswith("resnet"):
            self.backbone = ResNet(cfg.backbone)
            self.backbone.freeze(cfg.frozen_stages)
        elif cfg.backbone in SWIN_SPECS:  # no Swin stage is frozen (JAX is_frozen)
            self.backbone = SwinTransformer(*SWIN_SPECS[cfg.backbone],
                                            tp=tp if cfg.shard_backbone else None)
        elif cfg.backbone in STDC_LAYERS:  # nor any STDC parameter
            self.backbone = STDCNet(layers=STDC_LAYERS[cfg.backbone])
        elif cfg.backbone in VIT_SPECS:
            if cfg.shard_backbone:
                raise ValueError(f"{cfg.backbone}: a ViT backbone is not tensor-sharded")
            self.backbone = ViT(*VIT_SPECS[cfg.backbone])
        else:
            raise ValueError(f"unknown backbone {cfg.backbone}")
        # JAX nn.remat: the backward recomputes the backbone's activations
        # (ResNet and Swin; JAX does not remat STDC)
        self.remat_backbone = cfg.remat_backbone and cfg.backbone not in STDC_LAYERS
        if cfg.backbone in VIT_SPECS:
            self.neck = SimpleFeaturePyramid(self.backbone.out_channels, cfg.fpn_out_channels)
        else:
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
            feats = checkpoint(self._backbone, x, use_reentrant=False)
        else:
            feats = self._backbone(x)
        with span("model/neck"):
            return self.neck(feats)

    def _backbone(self, x: torch.Tensor):
        # inside what the remat recomputes, so the backward shows it too
        with span("model/backbone"):
            return self.backbone(x)

    def forward_heads(self, fpn_feats, with_aspp: bool = True) -> ModelOutput:
        """``with_aspp=False``: no ASPP map (serving never reads it)."""
        with span("model/kernel_head"):
            rpn = self.rpn_head(fpn_feats, with_aspp)
        proposal_feats, mask_preds = rpn.proposal_feats, rpn.mask_preds
        depth_proposal = rpn.depth_proposal
        stages = []
        for head in self.roi_head.mask_head:
            with span("model/stage"):
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
        with span("model/track_head"):
            return self.track_head(fpn_feats, masks, mask_valid, boxes)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from ``generator``: lecun-normal weights, unit
    norm scales, zero biases and BN statistics of an identity, the query
    kernels at std 1, Swin's relative-position bias tables and ViT's
    position table at std 0.02, and the classification biases at prior
    0.01."""
    prior = -math.log((1 - 0.01) / 0.01)
    with torch.no_grad():
        for name, p in [*model.named_parameters(), *model.named_buffers()]:
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                p.fill_(1.0)
            elif leaf == "running_mean":
                p.zero_()
            elif leaf.endswith("bias"):
                p.fill_(prior if name.endswith(("fc_cls.bias", "conv_seg.bias")) else 0.0)
            elif p.dim() == 1:  # norm scales
                p.fill_(1.0)
            else:
                if leaf in ("relative_position_bias_table", "pos_embed"):
                    std = 0.02
                elif "init_kernels" in name:
                    std = 1.0
                else:
                    std = 1.0 / math.sqrt(p[0].numel())
                draw = torch.randn(p.shape, generator=generator,
                                   device=generator.device) * std
                p.copy_(draw)


def build_model(cfg, device="cuda", generator: torch.Generator | None = None,
                state_dict=None, tp=None) -> PolyphonicFormer:
    """A model on ``device`` in eval mode, its weights drawn from
    ``generator`` or loaded (``strict=True``) from ``state_dict``: exactly
    one of the two.  Built on the meta device first, so construction itself
    draws nothing.  The parameters of the frozen backbone stages
    (``cfg.frozen_stages``) have ``requires_grad=False``.

    With ``tp`` (the mesh's model axis) and ``cfg.shard_backbone``: this
    rank's shard of the tensor-parallel model.  ``state_dict`` is then the
    full one, or a generator draws the full model on ``device`` first (the
    single-card model's weights); either is cut to the rank's shard
    (``weights.shard_state_dict``)."""
    if (generator is None) == (state_dict is None):
        raise ValueError("give exactly one of generator and state_dict")
    if tp is not None and cfg.shard_backbone:
        from ..weights import shard_state_dict

        if generator is not None:
            state_dict = build_model(cfg, device, generator=generator).state_dict()
        state_dict = shard_state_dict(state_dict, cfg, tp.index, tp.size)
        generator = None
    with torch.device("meta"):
        model = PolyphonicFormer(cfg, tp)
    model = model.to_empty(device=device)
    if generator is not None:
        init_weights(model, generator)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()
