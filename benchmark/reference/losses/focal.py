"""Sigmoid focal loss with mmcv/mmdet semantics; mirrors
``polyphonicformer_tpu/losses/focal.py``."""
from __future__ import annotations

import torch

from ..ops.depth import sigmoid


def sigmoid_focal_loss_elements(logits: torch.Tensor, onehot: torch.Tensor,
                                gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal loss. logits/onehot: (..., C)."""
    p = sigmoid(logits)
    t = onehot.to(logits.dtype)
    pt = (1.0 - p) * t + p * (1.0 - t)
    focal_weight = (alpha * t + (1.0 - alpha) * (1.0 - t)) * torch.pow(pt, gamma)
    bce = torch.clamp(logits, min=0.0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    return bce * focal_weight


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weight: torch.Tensor | None = None, avg_factor=None,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Focal loss over integer labels (N,) of logits (N, C); label C is
    background.  weight: per-sample (N,) or per-element (N, C)."""
    c = logits.shape[-1]
    onehot = labels[:, None] == torch.arange(c, device=labels.device)
    loss = sigmoid_focal_loss_elements(logits, onehot, gamma, alpha)
    if weight is not None:
        loss = loss * (weight[:, None] if weight.dim() == 1 else weight)
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype), min=1e-12)
