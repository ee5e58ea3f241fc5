"""End-to-end training losses of the image model; mirrors
``polyphonicformer_tpu/train/losses.py::compute_losses``:

* rpn (KernelHead) losses: mask BCE, dice, rank CE over the proposal rows,
  dense semantic focal loss, the ASPP head's softmax CE (with
  ``with_semantic_aspp``), masked depth and the (logged, not optimised)
  dense depth;
* per-stage (KernelUpdateHead) losses: cls focal with per-class weights,
  mask BCE, dice, rank CE and masked depth with the direct-depth last row;
* stage s is (re-)assigned on stage s-1's detached predictions, and every
  Hungarian problem of the step is solved in one batched call.

The mask, dice and rank reductions of each stack of stages go through K6
(``ops/cuda/mask_loss.py``), as the JAX package's ``_fused_mask_dice_rank``
does: the kernel on a CUDA tensor, its plain version on a CPU tensor.
:func:`compute_losses` is :func:`assign` followed by :func:`losses_from`;
the two halves are public so that a caller can time them apart.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ..data.structures import GTSample
from ..losses.cross_entropy import softmax_ce_ignore
from ..losses.depth_loss import depth_loss, depth_loss_stacked
from ..losses.focal import sigmoid_focal_loss_elements
from ..models.polyphonic import ModelOutput
from ..ops.cuda.mask_loss import IGNORE_LABEL, mask_loss_stats
from ..ops.resize import resize_bilinear
from .assign import (AssignResult, assignment_cost, focal_cls_cost, mask_dice_costs_stacked,
                     solve_assignments_lockstep)
from .targets import StageTargets, build_seg_target, build_stage_targets


def is_metric_key(k: str) -> bool:
    """True for loss-dict entries that are logged but not optimised: the
    ``*_acc`` metrics and the dense rpn depth, which the reference emits
    under a key without 'loss' (kernel_head.py:438), so mmdet's
    ``_parse_losses`` never sums it."""
    return k.endswith("_acc") or k == "loss_rpn_depth_dense"


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of the trailing (h, w) axes (K2 forward, K2b backward)."""
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


class Assignment(NamedTuple):
    """What :func:`assign` hands to :func:`losses_from`."""
    scaled_all_masks: torch.Tensor  # (1+S, B, Q, 2h, 2w) rpn and stage mask logits
    scaled_seg: torch.Tensor  # (B, C, 2h, 2w)
    scaled_depth0: torch.Tensor  # (B, 2h, 2w)
    scaled_stage_deps: torch.Tensor  # (S, B, Q, 2h, 2w)
    assigns: List[AssignResult]  # rpn, then each stage, leading axis B


def assign(cfg, out: ModelOutput, gt: GTSample) -> Assignment:
    """The x2 upsamples and every Hungarian matching of one step."""
    b = out.rpn.mask_preds.shape[0]
    nt, np_ = cfg.num_thing_classes, cfg.num_proposals
    n_stages = len(out.stages)

    # one stacked upsample for every mask volume: rpn.mask_preds[:, :P] are
    # the thing masks, so it feeds the rpn loss, every stage loss and cost
    scaled_all_masks = _upsample2(torch.stack(
        [out.rpn.mask_preds] + [so.mask_preds for so in out.stages]))
    scaled_seg = _upsample2(out.rpn.seg_preds)
    scaled_depth0 = _upsample2(out.rpn.depth_pred[:, None])[:, 0]
    scaled_stage_deps = _upsample2(torch.stack([so.depth_preds for so in out.stages]))

    det_all = scaled_all_masks.detach()
    det_cls = torch.stack([so.cls_score for so in out.stages]).detach()

    if cfg.rpn_assigner == cfg.rcnn_assigner and cfg.rcnn_assigner.depth_weight == 0:
        # the rpn assignment and the stage-0 re-assignment are the same
        # problem (both on the detached rpn thing masks, no cls term): solve
        # each distinct problem once, all in one batched call
        acfg = cfg.rcnn_assigner
        costs = mask_dice_costs_stacked(acfg, det_all[:n_stages, :, :np_], gt)
        if acfg.cls_weight != 0 and n_stages > 1:
            cls_c = focal_cls_cost(det_cls[:n_stages - 1, :, :np_, :nt], gt.thing_labels,
                                   acfg.focal_gamma, acfg.focal_alpha)
            costs = torch.cat([costs[:1], costs[1:] + acfg.cls_weight * cls_c])
        flat = solve_assignments_lockstep(costs.flatten(0, 1),
                                          gt.thing_valid.repeat(n_stages, 1), topk=acfg.topk)
        uniq = [AssignResult(*(a.unflatten(0, (n_stages, b))[i] for a in flat))
                for i in range(n_stages)]
        assigns = [uniq[0]] + uniq
    else:
        # every problem its own cost, one batched solve per topk group
        costs = [assignment_cost(cfg.rpn_assigner, det_all[0, :, :np_], None, gt),
                 assignment_cost(cfg.rcnn_assigner, det_all[0, :, :np_], None, gt)]
        costs += [assignment_cost(cfg.rcnn_assigner, det_all[s, :, :np_],
                                  det_cls[s - 1, :, :np_, :nt], gt)
                  for s in range(1, n_stages)]
        tk_rpn, tk_rcnn = cfg.rpn_assigner.topk, cfg.rcnn_assigner.topk
        groups = [(costs, tk_rpn)] if tk_rpn == tk_rcnn else \
            [(costs[:1], tk_rpn), (costs[1:], tk_rcnn)]
        assigns = []
        for group, topk in groups:
            ng = len(group)
            flat = solve_assignments_lockstep(torch.cat(group),
                                              gt.thing_valid.repeat(ng, 1), topk=topk)
            assigns += [AssignResult(*(a.unflatten(0, (ng, b))[i] for a in flat))
                        for i in range(ng)]
    return Assignment(scaled_all_masks, scaled_seg, scaled_depth0, scaled_stage_deps, assigns)


def _mask_dice_rank_losses_stacked(cfg, mask_logits: torch.Tensor, targets: StageTargets,
                                   gt: GTSample, num_rows: int, prefixes,
                                   losses: Dict[str, torch.Tensor]) -> None:
    """Mask BCE, dice and rank CE over the first ``num_rows`` rows of S
    stacked problems, (S, B, Q', h, w) logits, through K6: the
    normalisations of the JAX package's ``_fused_mask_dice_rank``."""
    if cfg.ignore_label != IGNORE_LABEL:
        raise NotImplementedError(f"the mask-loss kernel fixes ignore_label {IGNORE_LABEL}")
    s, b, q, h, w = mask_logits.shape
    pos = targets.pos_row[..., :num_rows].float()  # (S, B, Q')
    tgt = targets.mask_targets[..., :num_rows, :, :]
    valid = gt.valid_mask.float()  # (B, h, w)
    stats, dice_abc = mask_loss_stats(
        mask_logits.float().reshape(s * b, q, h, w).contiguous(),
        tgt.float().reshape(s * b, q, h, w).contiguous(),
        pos.reshape(s * b, q).contiguous(),
        valid.expand(s, b, h, w).reshape(s * b, h, w).contiguous(),
        targets.rank_target.reshape(s * b, h, w).int().contiguous())
    stats = stats.reshape(s, b, 2)
    dice_abc = dice_abc.reshape(s, b, 3, q)

    denom = torch.clamp(torch.einsum("sbq,b->s", pos, valid.sum(dim=(1, 2))), min=1.0)
    mask_vec = cfg.loss_mask_weight * stats[..., 0].sum(dim=1) / denom
    a, bb, cc = dice_abc[:, :, 0], dice_abc[:, :, 1] + 1e-3, dice_abc[:, :, 2] + 1e-3
    dice = 1.0 - 2.0 * a / (bb + cc)  # (S, B, Q')
    num_pos = torch.clamp(pos.sum(dim=(1, 2)), min=1.0)
    dice_vec = cfg.loss_dice_weight * (dice * pos).sum(dim=(1, 2)) / num_pos
    rank_vec = cfg.loss_rank_weight * stats[..., 1].sum(dim=1) / (b * h * w)
    for i, p in enumerate(prefixes):
        losses[f"{p}_mask"] = mask_vec[i]
        losses[f"{p}_dice"] = dice_vec[i]
        losses[f"{p}_rank"] = rank_vec[i]


def _depth_stage_loss(depth_logits: torch.Tensor, targets: StageTargets, gt: GTSample,
                      wcfg) -> torch.Tensor:
    """Masked per-query depth loss; depth_logits (B, Q, h, w)."""
    tgt = gt.depth[:, None] * targets.depth_has_target[:, :, None, None]
    return depth_loss(depth_logits, tgt, targets.depth_weights, loss_weight=wcfg.loss_weight,
                      depth_act_mode=wcfg.depth_act_mode, si_weight=wcfg.si_weight,
                      sq_rel_weight=wcfg.sq_rel_weight, abs_rel_weight=wcfg.abs_rel_weight)


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``one_hot(labels, num_classes + 1)[..., :num_classes]`` in f32, by
    comparison (``F.one_hot`` reads its input back to check it)."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).float()


def losses_from(cfg, out: ModelOutput, gt: GTSample, asg: Assignment
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Targets and losses of one forward given its assignment."""
    losses: Dict[str, torch.Tensor] = {}
    b = out.rpn.mask_preds.shape[0]
    nt, nc = cfg.num_thing_classes, cfg.num_classes
    np_, nq = cfg.num_proposals, cfg.num_queries
    n_stages = len(out.stages)
    rpn_assign = asg.assigns[0]

    rpn_targets = build_stage_targets(rpn_assign, gt, np_, nt, nc, cfg.ignore_label,
                                      with_direct_row=False, stuff_in_rank=False,
                                      stuff_depth_bool=True)
    _mask_dice_rank_losses_stacked(cfg, asg.scaled_all_masks[0, :, :np_][None],
                                   StageTargets(*(t[None] for t in rpn_targets)), gt, np_,
                                   ["loss_rpn"], losses)

    # dense semantic focal loss (kernel_head.py:541-553)
    seg_target = build_seg_target(rpn_assign, gt, nt, nc)
    seg_logits = asg.scaled_seg.movedim(1, -1).float()  # (B, h, w, C)
    seg_valid = (seg_target != nc).float()
    focal = sigmoid_focal_loss_elements(seg_logits, _onehot(seg_target, nc),
                                        cfg.focal_gamma, cfg.focal_alpha)
    losses["loss_rpn_seg"] = cfg.loss_seg_weight * (
        focal * seg_valid[..., None]).sum() / torch.clamp(seg_valid.sum(), min=1.0)

    # the ASPP head's softmax CE, ignore_index = num_classes, over the same
    # dense target and x2 upsampled like seg_preds (K2, K2b)
    if out.rpn.aspp_seg_preds is not None:
        scaled_aspp = _upsample2(out.rpn.aspp_seg_preds).movedim(1, -1)
        losses["loss_aspp_semseg"] = cfg.loss_aspp_weight * softmax_ce_ignore(
            scaled_aspp, seg_target, ignore_index=nc)

    # masked depth over the Q rows of the (one) dense depth, and dense depth
    rpn_depth_logits = asg.scaled_depth0[:, None].expand(b, nq, *asg.scaled_depth0.shape[1:])
    losses["loss_rpn_depth"] = _depth_stage_loss(rpn_depth_logits, rpn_targets, gt,
                                                 cfg.rpn_depth_loss)
    losses["loss_rpn_depth_dense"] = depth_loss(
        asg.scaled_depth0, gt.depth, (gt.depth > 0).float(),
        loss_weight=cfg.rpn_depth_loss.loss_weight,
        depth_act_mode=cfg.rpn_depth_loss.depth_act_mode)

    # refinement stages, stacked on a leading S axis
    stage_assigns = AssignResult(*(torch.stack(t) for t in zip(*asg.assigns[1:])))
    targets = build_stage_targets(stage_assigns, gt, np_, nt, nc, cfg.ignore_label,
                                  with_direct_row=True)
    prefixes = [f"s{i}_loss" for i in range(n_stages)]
    pos = targets.pos_row.float()  # (S, B, Q)
    num_pos_vec = torch.clamp(pos.sum(dim=(1, 2)) / b, min=1.0)
    stage_cls = torch.stack([so.cls_score for so in out.stages]).float()
    focal = sigmoid_focal_loss_elements(stage_cls, _onehot(targets.labels, nc),
                                        cfg.focal_gamma, cfg.focal_alpha)
    cls_vec = cfg.loss_cls_weight * (
        (focal * targets.label_weights).sum(dim=(1, 2, 3)) / (num_pos_vec * b))
    for i, p in enumerate(prefixes):
        losses[f"{p}_cls"] = cls_vec[i]
    # top-1 accuracy on positive queries: a metric, not optimised
    correct = (torch.argmax(stage_cls, dim=-1) == targets.labels).float() * pos
    acc_vec = 100.0 * correct.sum(dim=(1, 2)) / torch.clamp(pos.sum(dim=(1, 2)), min=1.0)
    for i in range(n_stages):
        losses[f"s{i}_pos_acc"] = acc_vec[i]

    _mask_dice_rank_losses_stacked(cfg, asg.scaled_all_masks[1:], targets, gt, nq, prefixes,
                                   losses)
    wcfg = cfg.rcnn_depth_loss
    dep_tgt = gt.depth[None, :, None] * targets.depth_has_target[..., None, None]
    dep_vec = depth_loss_stacked(asg.scaled_stage_deps, dep_tgt, targets.depth_weights,
                                 loss_weight=wcfg.loss_weight,
                                 depth_act_mode=wcfg.depth_act_mode,
                                 si_weight=wcfg.si_weight, sq_rel_weight=wcfg.sq_rel_weight,
                                 abs_rel_weight=wcfg.abs_rel_weight)
    for i, p in enumerate(prefixes):
        losses[f"{p}_depth"] = dep_vec[i]

    total = torch.stack([v for k, v in losses.items() if not is_metric_key(k)]).sum()
    return total, losses


def compute_losses(cfg, out: ModelOutput, gt: GTSample
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, loss dict) of one image-model forward; gt is batched."""
    return losses_from(cfg, out, gt, assign(cfg, out, gt))
