"""Hungarian assignment costs and matching, batched on the device; mirrors
``polyphonicformer_tpu/train/assign.py`` (the reference's FocalLossCost,
MaskCost and DiceCost with weights cls=2, dice=4, mask=1).

The JAX functions are per image and vmapped by their callers; here every
function takes leading batch axes.  An :class:`AssignResult` always carries
its matching rounds: ``gt2pred`` is (..., R, M) with R = ``topk`` (1 for
the shipped configs), where the JAX result is (M,) for topk 1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..data.structures import GTSample
from ..ops.depth import sigmoid
from ..ops.hungarian import gt2pred_to_assignment, match_gt_to_preds_batched


class AssignResult(NamedTuple):
    pred2gt: torch.Tensor  # (..., P) int32 thing slot, -1 = background
    gt2pred: torch.Tensor  # (..., R, M) int32 per round, -1 = invalid gt


def focal_cls_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                   gamma: float = 2.0, alpha: float = 0.25,
                   eps: float = 1e-12) -> torch.Tensor:
    """mmdet FocalLossCost. cls_logits (..., N, C), gt_labels (..., M)
    (clipped to the class range) -> (..., N, M)."""
    p = sigmoid(cls_logits.float())
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * torch.pow(p, gamma)
    pos_cost = -torch.log(p + eps) * alpha * torch.pow(1 - p, gamma)
    cost = pos_cost - neg_cost  # (..., N, C)
    safe = gt_labels.clamp(0, cls_logits.shape[-1] - 1).long()
    idx = safe[..., None, :].expand(*cost.shape[:-1], safe.shape[-1])
    return torch.gather(cost, -1, idx)


def mask_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
              gt_valid_pixels: torch.Tensor) -> torch.Tensor:
    """reference MaskCost: -(pos + neg agreement) / norm over the valid
    pixels.  (..., N, h, w) logits, (..., M, h, w) masks, (..., h, w)
    valid -> (..., N, M)."""
    p = sigmoid(mask_logits.float())
    t = gt_masks.float()
    v = gt_valid_pixels.float()
    pos = torch.einsum("...nhw,...mhw,...hw->...nm", p, t, v)
    neg = torch.einsum("...nhw,...mhw,...hw->...nm", 1 - p, 1 - t, v)
    return -(pos + neg) / torch.clamp(v.sum(dim=(-2, -1)), min=1.0)[..., None, None]


def dice_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
              gt_valid_pixels: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """reference DiceCost: -2a / (b + c), shapes as :func:`mask_cost`."""
    p = sigmoid(mask_logits.float()).flatten(-2)
    t = gt_masks.float().flatten(-2)
    v = gt_valid_pixels.float().flatten(-2)
    a = torch.einsum("...nk,...mk,...k->...nm", p, t, v)
    b = (p * p * v[..., None, :]).sum(dim=-1) + eps
    c = (t * t * v[..., None, :]).sum(dim=-1) + eps
    return -(2 * a) / (b[..., :, None] + c[..., None, :])


def mask_dice_costs_stacked(cfg, mask_logits: torch.Tensor, gt: GTSample) -> torch.Tensor:
    """Weighted mask + dice cost of S stacked problems sharing one batched
    GT: (S, B, P, h, w) detached logits -> (S, B, P, M).  The MaskCost
    negative term expands to sum(v) - sum(p v) - sum(t v) + sum(p t v), so
    one p.t.v contraction feeds the mask and the dice costs."""
    p = sigmoid(mask_logits.float())
    t = gt.thing_masks.float()  # (B, M, h, w)
    v = gt.valid_mask.float()  # (B, h, w)
    pv = p * v[None, :, None]
    ptv = torch.einsum("sbphw,bmhw->sbpm", pv, t)
    pvs = pv.sum(dim=(-2, -1))  # (S, B, P)
    p2v = (p * pv).sum(dim=(-2, -1))
    tv = torch.einsum("bmhw,bhw->bm", t, v)
    t2v = torch.einsum("bmhw,bhw->bm", t * t, v)
    vsum = v.sum(dim=(1, 2))  # (B,)
    neg = vsum[None, :, None, None] - pvs[..., None] - tv[None, :, None] + ptv
    mask_c = -(ptv + neg) / torch.clamp(vsum, min=1.0)[None, :, None, None]
    dice_c = -(2.0 * ptv) / ((p2v[..., None] + 1e-3) + (t2v[None, :, None] + 1e-3))
    return cfg.mask_weight * mask_c + cfg.dice_weight * dice_c


def assignment_cost(cfg, mask_logits: torch.Tensor, cls_logits: Optional[torch.Tensor],
                    gt: GTSample) -> torch.Tensor:
    """The (..., P, M) pairwise cost of batched problems over the valid
    pixels (the JAX function's depth term and its all-pixel form have no
    caller on this path)."""
    cost = cfg.mask_weight * mask_cost(mask_logits, gt.thing_masks, gt.valid_mask)
    cost = cost + cfg.dice_weight * dice_cost(mask_logits, gt.thing_masks, gt.valid_mask)
    if cls_logits is not None and cfg.cls_weight != 0:
        cost = cost + cfg.cls_weight * focal_cls_cost(
            cls_logits, gt.thing_labels, cfg.focal_gamma, cfg.focal_alpha)
    return cost


def solve_assignments_lockstep(costs: torch.Tensor, valids: torch.Tensor,
                               topk: int = 1) -> AssignResult:
    """N independent problems at once: costs (N, P, M), valids (N, M).

    Each round is one batched solve (one K5 launch on the card).  topk > 1
    reproduces the reference's multi-round matching: after a round the
    matched prediction rows cost 1e10 and the solve repeats, so each GT
    collects its ``topk`` best rows; ``pred2gt`` merges the rounds."""
    num_preds = costs.shape[1]
    work = costs.float()
    pred2gt = None
    rounds = []
    for _ in range(max(topk, 1)):
        g2p = match_gt_to_preds_batched(work.transpose(1, 2), valids)
        p2g = gt2pred_to_assignment(g2p, num_preds)
        pred2gt = p2g if pred2gt is None else torch.where(pred2gt < 0, p2g, pred2gt)
        rounds.append(g2p)
        if topk > 1:
            work = torch.where((p2g >= 0)[:, :, None], 1e10, work)
    return AssignResult(pred2gt=pred2gt, gt2pred=torch.stack(rounds, dim=1))


def solve_assignment(cost: torch.Tensor, gt_valid: torch.Tensor, num_preds: int,
                     topk: int = 1) -> AssignResult:
    """One problem: cost (P, M), gt_valid (M,)."""
    if cost.shape[0] != num_preds:
        raise ValueError(f"cost has {cost.shape[0]} rows, not {num_preds}")
    res = solve_assignments_lockstep(cost[None], gt_valid[None], topk)
    return AssignResult(pred2gt=res.pred2gt[0], gt2pred=res.gt2pred[0])
