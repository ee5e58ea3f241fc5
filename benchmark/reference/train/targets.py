"""Training targets from an assignment, batched; mirrors
``polyphonicformer_tpu/train/targets.py`` (the reference's rcnn stage
targets, kernel_update_head.py:443-534, and rpn targets,
kernel_head.py:571-640).  The reference's ascending overwrite loops become
max/argmax reductions: the last writer in ascending order is the argmax
over the index.

The JAX functions are per image; here an assignment carries leading axes
``L`` that end with the batch axis B of the GT (for example (B,) for the rpn
and (S, B) for the stacked stages), and every target gets them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..data.structures import GTSample
from .assign import AssignResult


class StageTargets(NamedTuple):
    labels: torch.Tensor  # (*L, Q) int32, num_classes = background
    label_weights: torch.Tensor  # (*L, Q, C) f32
    mask_targets: torch.Tensor  # (*L, Q, h, w) f32 soft masks
    pos_row: torch.Tensor  # (*L, Q) bool, rows with a foreground label
    rank_target: torch.Tensor  # (*L, h, w) int32, ignore_label = ignore
    depth_weights: torch.Tensor  # (*L, Q, h, w) f32 (already x (depth > 0))
    depth_has_target: torch.Tensor  # (*L, Q) f32, rows whose target is the depth


def _matched(assign: AssignResult, gt: GTSample) -> torch.Tensor:
    """(*L, R, M) bool: valid GTs matched in each round."""
    return gt.thing_valid[:, None, :] & (assign.gt2pred >= 0)


def _scatter_thing_rows(values: torch.Tensor, assign: AssignResult, gt: GTSample,
                        num_rows: int) -> torch.Tensor:
    """Per-GT values (B, M, h, w) into prediction rows (*L, num_rows, h, w),
    as a one-hot contraction (rows matched in different rounds are
    disjoint, so the sum is the scatter)."""
    rows = torch.arange(num_rows, device=values.device)
    onehot = ((assign.gt2pred[..., None] == rows) & _matched(assign, gt)[..., None]).any(dim=-3)
    return torch.einsum("...mq,...mhw->...qhw", onehot.float(), values.float())


def _thing_rank(assign: AssignResult, gt: GTSample) -> torch.Tensor:
    """(*L, R*M, h, w) int32: the matched row of each (round, GT) on the GT's
    pixels, -1 elsewhere."""
    matched = _matched(assign, gt)
    rows = torch.where(matched, assign.gt2pred, -1).int()
    on = gt.thing_masks[:, None] > 0  # (B, 1, M, h, w)
    cand = torch.where(on, rows[..., None, None], -1)
    return cand.flatten(-4, -3)


def build_stage_targets(assign: AssignResult, gt: GTSample, num_proposals: int,
                        num_things: int, num_classes: int, ignore_label: int = 255,
                        with_direct_row: bool = True, stuff_in_rank: bool = True,
                        stuff_depth_bool: bool = False) -> StageTargets:
    """Targets of one kernel-update stage (Q = num_proposals + num_stuff).

    with_direct_row: rcnn stages make the last row regress the full-image
    depth; the rpn does not.  stuff_in_rank: rcnn rank targets cover the
    stuff rows; the rpn's rank loss has only the proposal rows.
    stuff_depth_bool: the rpn binarises the stuff rows' depth weights
    (kernel_head.py:594 rebinds ``gt_sem_seg`` to bool before :633 reuses
    it), the stages keep the soft masks."""
    dev = assign.pred2gt.device
    num_stuff = num_classes - num_things
    q = num_proposals + num_stuff
    lead = assign.pred2gt.shape[:-1]
    matched = _matched(assign, gt)

    labels = torch.full((*lead, q + 1), num_classes, dtype=torch.int32, device=dev)
    for r in range(assign.gt2pred.shape[-2]):
        m_r = matched[..., r, :]
        idx = torch.where(m_r, assign.gt2pred[..., r, :], q).long()
        labels = labels.scatter(-1, idx, torch.where(m_r, gt.thing_labels, num_classes).int())
    stuff_labels = torch.where(
        gt.stuff_valid, torch.arange(num_stuff, device=dev, dtype=torch.int32) + num_things,
        num_classes).int()
    labels = torch.cat([labels[..., :num_proposals], stuff_labels.expand(*lead, num_stuff)],
                       dim=-1)

    # thing rows never supervise stuff logits; stuff rows only their own class
    lw = torch.ones((q, num_classes), dtype=torch.float32, device=dev)
    lw[:num_proposals, num_things:] = 0.0
    lw[num_proposals:] = 0.0
    lw[num_proposals:, num_things:] = torch.eye(num_stuff, device=dev)
    label_weights = lw.expand(*lead, q, num_classes)

    thing_part = _scatter_thing_rows(gt.thing_masks, assign, gt, num_proposals)
    stuff_part = (gt.stuff_masks * gt.stuff_valid[..., None, None]).expand(
        *lead, *gt.stuff_masks.shape[1:])
    mask_targets = torch.cat([thing_part, stuff_part], dim=-3)
    pos_row = (labels >= 0) & (labels < num_classes)

    # rank target: the last (highest-index) positive row covering each pixel
    rank = _thing_rank(assign, gt).amax(dim=-3)
    if stuff_in_rank:
        cand = torch.where((gt.stuff_masks > 0) & gt.stuff_valid[..., None, None],
                           (torch.arange(num_stuff, device=dev, dtype=torch.int32)
                            + num_proposals)[:, None, None], -1)
        rank = torch.maximum(rank, cand.amax(dim=-3))
    rank_target = torch.where(rank >= 0, rank, ignore_label).int()

    depth_valid = (gt.depth > 0).float()
    if stuff_depth_bool:
        depth_weights = torch.cat([thing_part, (stuff_part > 0).float()], dim=-3)
    else:
        depth_weights = mask_targets
    depth_has_target = pos_row.float()
    if with_direct_row:
        depth_weights = torch.cat([depth_weights[..., :-1, :, :],
                                   torch.ones_like(depth_weights[..., -1:, :, :])], dim=-3)
        depth_has_target = torch.cat([depth_has_target[..., :-1],
                                      torch.ones_like(depth_has_target[..., -1:])], dim=-1)
    depth_weights = depth_weights * depth_valid[:, None]
    return StageTargets(labels=labels, label_weights=label_weights,
                        mask_targets=mask_targets, pos_row=pos_row, rank_target=rank_target,
                        depth_weights=depth_weights, depth_has_target=depth_has_target)


def build_seg_target(assign: AssignResult, gt: GTSample, num_things: int,
                     num_classes: int) -> torch.Tensor:
    """Dense semantic target of the rpn seg loss, (B, h, w) int32 for an
    assignment with leading axes (B,): stuff classes in ascending class
    order, then the matched things in ascending row order."""
    dev = gt.depth.device
    num_stuff = num_classes - num_things
    m = gt.thing_masks.shape[1]
    score = _thing_rank(assign, gt)  # (B, R*M, h, w)
    best = torch.argmax(score, dim=1) % m
    has_thing = score.amax(dim=1) >= 0
    thing_label = torch.gather(gt.thing_labels, 1, best.flatten(1)).reshape(best.shape)
    cand = torch.where((gt.stuff_masks > 0) & gt.stuff_valid[..., None, None],
                       torch.arange(num_stuff, device=dev)[:, None, None], -1)
    smax = cand.amax(dim=1)
    seg = torch.where(smax >= 0, smax + num_things, num_classes)
    return torch.where(has_thing, thing_label, seg).int()
