"""Cross-entropy losses with mmdet reduction semantics; mirrors
``polyphonicformer_tpu/losses/cross_entropy.py``.  The 'mean' of the
softmax CE divides by ALL positions, ignored ones included, as mmdet does."""
from __future__ import annotations

import torch


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    t = targets.to(logits.dtype)
    return torch.clamp(logits, min=0.0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def masked_bce_mean(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Mean BCE over the elements selected by ``mask``."""
    loss = binary_cross_entropy_with_logits(logits.float(), targets)
    m = mask.float()
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


def softmax_ce_ignore(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Softmax CE over the last axis of (..., C) logits with ignore_index,
    averaged over all positions."""
    c = logits.shape[-1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < c)
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).mean()
