"""Three-term depth loss (scale-invariant log + sqrt squared-relative +
absolute-relative); mirrors ``polyphonicformer_tpu/losses/depth_loss.py``:
points with 0 < target < 80 and weight != 0, the soft weight multiplied
into the residuals, normalised by the point count; the loss is
``loss_weight * mean(si * w_si, sq * w_sq, abs * w_abs)``.  Under data
parallelism the point count and the error sums are the global batch's
(``parallel.mesh.global_sums``)."""
from __future__ import annotations

import torch

from ..ops.depth import depth_act
from ..single import global_sums


def depth_loss_raw_stacked(pred_depth: torch.Tensor, target: torch.Tensor,
                           mask_weight: torch.Tensor, min_depth: float = 0.0,
                           max_depth: float = 80.0) -> torch.Tensor:
    """S problems stacked on axis 0 of activated (metric) depth; returns
    (S, 3) [si_err, sq_rel_err, abs_rel_err], zeros where a problem has no
    valid point."""
    s = pred_depth.shape[0]
    pred = pred_depth.float().reshape(s, -1)
    t = target.float().reshape(s, -1)
    w = mask_weight.float().reshape(s, -1)
    mask = (t > min_depth) & (t < max_depth) & (w != 0)
    mf = mask.float()
    safe_t = torch.where(mask, t, 1.0)
    safe_p = torch.where(mask, pred, 1.0)
    log_minus = (torch.log(safe_p) - torch.log(safe_t)) * w * mf
    minus = (safe_p - safe_t) * w * mf
    n, log_sq, log_sum, rel_sq, rel_abs = global_sums(
        mf.sum(dim=1), log_minus.square().sum(dim=1), log_minus.sum(dim=1),
        (minus / safe_t).square().sum(dim=1), (minus / safe_t).abs().sum(dim=1))
    n_safe = torch.clamp(n, min=1.0)
    si_err = log_sq / n_safe - log_sum / (n_safe * n_safe)
    sq_rel = torch.sqrt(torch.clamp(rel_sq / n_safe, min=1e-20))
    abs_rel = rel_abs / n_safe
    out = torch.stack([si_err, sq_rel, abs_rel], dim=1)
    return torch.where((n > 0)[:, None], out, 0.0)


def depth_loss_raw(pred_depth: torch.Tensor, target: torch.Tensor,
                   mask_weight: torch.Tensor, min_depth: float = 0.0,
                   max_depth: float = 80.0) -> torch.Tensor:
    """One problem: (3,) [si_err, sq_rel_err, abs_rel_err]."""
    return depth_loss_raw_stacked(pred_depth[None], target[None], mask_weight[None],
                                  min_depth, max_depth)[0]


def _weighted_mean(errs: torch.Tensor, weights) -> torch.Tensor:
    """mean over the three terms of errs (S, 3) times their weights (the
    weights multiply column by column: no host-to-device copy)."""
    return torch.stack([errs[:, k] * wk for k, wk in enumerate(weights)], dim=1).mean(dim=1)


def depth_loss_stacked(pred_logits: torch.Tensor, target: torch.Tensor,
                       mask_weight: torch.Tensor, loss_weight: float = 1.0,
                       depth_act_mode: str = "sigmoid", si_weight: float = 1.0,
                       sq_rel_weight: float = 1.0, abs_rel_weight: float = 1.0) -> torch.Tensor:
    """``depth_loss`` over S stacked problems of raw logits; returns (S,)."""
    errs = depth_loss_raw_stacked(depth_act(pred_logits, mode=depth_act_mode), target,
                                  mask_weight)
    return loss_weight * _weighted_mean(errs, (si_weight, sq_rel_weight, abs_rel_weight))


def depth_loss(pred_logits: torch.Tensor, target: torch.Tensor, mask_weight: torch.Tensor,
               loss_weight: float = 1.0, depth_act_mode: str = "sigmoid",
               si_weight: float = 1.0, sq_rel_weight: float = 1.0,
               abs_rel_weight: float = 1.0) -> torch.Tensor:
    """DepthLoss.forward: activates the raw logits, computes the three
    errors, weights them and takes their mean."""
    return depth_loss_stacked(pred_logits[None], target[None], mask_weight[None],
                              loss_weight, depth_act_mode, si_weight, sq_rel_weight,
                              abs_rel_weight)[0]
