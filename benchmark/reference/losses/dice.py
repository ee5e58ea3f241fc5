"""Dice loss with mmdet semantics (activate=True, eps=1e-3); mirrors
``polyphonicformer_tpu/losses/dice.py``."""
from __future__ import annotations

import torch

from ..ops.depth import sigmoid


def dice_loss_per_row(pred_logits: torch.Tensor, target: torch.Tensor,
                      pixel_mask: torch.Tensor | None = None,
                      eps: float = 1e-3) -> torch.Tensor:
    """(N, ...) logits and targets in [0, 1], optional 0/1 pixel mask
    broadcastable to them -> (N,) loss per row."""
    p = sigmoid(pred_logits.float())
    t = target.float()
    if pixel_mask is not None:
        m = pixel_mask.float()
        p, t = p * m, t * m
    p = p.reshape(p.shape[0], -1)
    t = t.reshape(t.shape[0], -1)
    a = (p * t).sum(dim=1)
    b = (p * p).sum(dim=1) + eps
    c = (t * t).sum(dim=1) + eps
    return 1.0 - (2.0 * a) / (b + c)
