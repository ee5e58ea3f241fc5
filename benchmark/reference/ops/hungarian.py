"""Exact linear-sum assignment on the device; mirrors
``polyphonicformer_tpu/ops/hungarian.py``.

:func:`match_gt_to_preds_batched` solves every problem at once, with the
costs prepared as the JAX package prepares them (invalid GT rows set to 0,
non-finite entries clamped to +-1e8): on a CUDA tensor the K5 kernel reads
the raw costs through their strides and prepares them itself, the only
launch; a CPU tensor takes its plain version (``ops/cuda/lsa.py``).  The
solution matches scipy's rectangular ``linear_sum_assignment``, ties to the
lowest column.
"""
from __future__ import annotations

import torch

from ..kernels import solve_lsa


def match_gt_to_preds_batched(cost_gt_pred: torch.Tensor,
                              gt_valid: torch.Tensor) -> torch.Tensor:
    """(N, MAX_GT, P) costs with MAX_GT <= P, (N, MAX_GT) bool valid ->
    (N, MAX_GT) int32 matched prediction column, -1 for invalid rows."""
    n, g, p = cost_gt_pred.shape
    if g > p:
        raise ValueError(f"more GT slots ({g}) than predictions ({p})")
    return solve_lsa(cost_gt_pred.float(), gt_valid)


def gt2pred_to_assignment(gt2pred: torch.Tensor, num_preds: int) -> torch.Tensor:
    """Invert gt -> pred matchings (..., M) into pred -> gt (..., num_preds)
    int32, -1 for background."""
    idx = torch.where(gt2pred >= 0, gt2pred, num_preds).long()
    src = torch.arange(gt2pred.shape[-1], dtype=torch.int32,
                       device=gt2pred.device).expand(gt2pred.shape)
    out = torch.full((*gt2pred.shape[:-1], num_preds + 1), -1, dtype=torch.int32,
                     device=gt2pred.device)
    return out.scatter(-1, idx, src)[..., :num_preds]
