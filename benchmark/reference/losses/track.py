"""Tracking losses: the multi-positive contrastive cross-entropy and the
hard-mined L2 auxiliary loss; mirrors ``polyphonicformer_tpu/losses/track.py``
(reference qdtrack ``multipos_cross_entropy_loss.py`` and ``l2_loss.py``).

Static shapes: rows and columns are padded to a fixed capacity and carry
validity masks, and padded entries join neither the positive nor the
negative set.  Hard mining keeps the negatives whose rank among the sorted
costs is below a data-dependent cap; the cap and the decision to apply it
stay device tensors, so nothing is read back to the host.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30  # a finite sentinel: neg - pos of two sentinels is -2e30


def multi_pos_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                            pair_valid: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Multi-positive contrastive loss.

    pred: (K, R) similarity logits; target: (K, R) 0/1 match matrix;
    pair_valid: (K, R) bool, False for padded entries; row_valid: (K,) bool.
    Returns the scalar sum_i w_i loss_i / sum_i w_i, w_i = row i is valid
    and has at least one positive, where loss_i is the logsumexp of every
    (negative - positive) difference of row i and an extra 0 term.
    """
    pred = pred.float()
    is_pos = (target == 1) & pair_valid
    is_neg = (target == 0) & pair_valid
    pos_vals = torch.where(is_pos, pred, torch.full_like(pred, -_NEG_INF))
    neg_vals = torch.where(is_neg, pred, torch.full_like(pred, _NEG_INF))
    k = pred.shape[0]
    diff = (neg_vals[:, :, None] - pos_vals[:, None, :]).reshape(k, -1)
    diff = torch.cat([diff, diff.new_zeros((k, 1))], dim=1)
    loss = torch.logsumexp(diff, dim=1)
    weights = ((is_pos.sum(dim=1) > 0) & row_valid).float()
    return (loss * weights).sum() / torch.clamp(weights.sum(), min=1e-12)


def l2_aux_loss(cos_dist: torch.Tensor, target: torch.Tensor, pair_valid: torch.Tensor,
                neg_pos_ub: int = 3, pos_margin: float = 0.0, neg_margin: float = 0.1,
                hard_mining: bool = True) -> torch.Tensor:
    """Hard-mined L2 loss on (K, R) cosine similarities: positives pulled to
    1, negatives (less ``neg_margin``) to 0, at most ``neg_pos_ub``
    negatives a positive kept (the costliest) when there are more."""
    pred = cos_dist.float()
    t = torch.where(pair_valid, target, torch.full_like(target, -1))
    is_pos = t == 1
    is_neg = t == 0
    if pos_margin > 0:
        pred = torch.where(is_pos, pred - pos_margin, pred)
    if neg_margin > 0:
        pred = torch.where(is_neg, pred - neg_margin, pred)
    pred = torch.clamp(pred, 0.0, 1.0)

    weight = pair_valid.float()
    if neg_pos_ub > 0:
        num_pos = is_pos.sum()
        num_neg = is_neg.sum()
        cap = num_pos * neg_pos_ub
        needs_cap = num_neg / (num_pos + 1) > neg_pos_ub
        if hard_mining:
            with torch.no_grad():
                cost = torch.where(is_neg, torch.square(pred - t.float()),
                                   torch.full_like(pred, -1.0))
                flat = cost.reshape(-1)
                order = torch.argsort(-flat, stable=True)  # descending cost, ties in order
                rank = torch.empty_like(order).scatter_(
                    0, order, torch.arange(flat.numel(), device=flat.device))
                keep_neg = (rank < cap).reshape(cost.shape)
        else:
            keep_neg = is_neg  # no random choice; hard mining is the shipped setting
        drop = is_neg & ~keep_neg & needs_cap
        weight = torch.where(drop, torch.zeros_like(weight), weight)
    tt = is_pos.float()
    used = weight * (is_pos | is_neg).float()
    loss = torch.square(pred - tt) * used
    return loss.sum() / torch.clamp(used.sum(), min=1e-12)
