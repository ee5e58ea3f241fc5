"""Video (2-frame) training: the key frame's losses plus the quasi-dense
track losses; mirrors ``polyphonicformer_tpu/train/video_losses.py``.

The ref frame's features carry no gradient (the reference runs that branch
under no_grad); the track head still gets gradients from the ref side.  The
track rows are the GT slots themselves: the reference's track assignment
only orders the positive rows, and both track losses are invariant to
row and column permutations.  The GT boxes of both frames come from the
exact stride-4 support marginals (:func:`gt_track_boxes`), never from the
(B, M, H, W) upsampled GT volume; :func:`gt_track_masks` is that volume,
kept as the boxes' oracle.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..data.structures import GTSample, TrainBatch
from ..losses.track import l2_aux_loss, multi_pos_cross_entropy
from ..models.polyphonic import PolyphonicFormer
from ..ops.resize import resize_bilinear
from ..ops.roi_align import boxes_mad_from_marginals, upsampled_support_marginals
from ..parallel.mesh import data_world, global_sums
from ..utils.profiling import span
from .losses import compute_losses


def _safe_normalize(e: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm; a zero (padded) row stays zero with a finite
    gradient, which ``e / ||e||`` does not give."""
    return e * torch.rsqrt((e * e).sum(dim=1, keepdim=True) + 1e-12)


def track_pair_losses(cfg, key_embeds: torch.Tensor, ref_embeds: torch.Tensor,
                      key_gt: GTSample, ref_gt: GTSample) -> Dict[str, torch.Tensor]:
    """key_embeds, ref_embeds: (B, M, E) GT-slot embeddings (padded rows
    zero).  Matches are shared instance ids.  ``cfg``: a ``ModelConfig``."""
    th = cfg.track_head
    lt, la = [], []
    for b in range(key_embeds.shape[0]):
        ke, re = key_embeds[b], ref_embeds[b]
        kids, rids = key_gt.thing_inst_ids[b], ref_gt.thing_inst_ids[b]
        kval = key_gt.thing_valid[b]
        target = ((kids[:, None] == rids[None, :]) & (kids[:, None] >= 0)).int()
        pair_valid = kval[:, None] & ref_gt.thing_valid[b][None, :]
        lt.append(multi_pos_cross_entropy(ke @ re.T, target, pair_valid, kval))
        cos = _safe_normalize(ke) @ _safe_normalize(re).T
        la.append(l2_aux_loss(cos, target, pair_valid, neg_pos_ub=th.aux_neg_pos_ub,
                              pos_margin=th.aux_pos_margin, neg_margin=th.aux_neg_margin,
                              hard_mining=th.aux_hard_mining))
    lt, la = torch.stack(lt), torch.stack(la)
    lt_sum, la_sum = global_sums(lt.sum(), la.sum())  # means over the global batch
    gb = lt.numel() * data_world()
    return {"loss_track": th.loss_track_weight * (lt_sum / gb),
            "loss_track_aux": th.loss_aux_weight * (la_sum / gb)}


def gt_track_masks(gt: GTSample, pad_hw) -> torch.Tensor:
    """The (B, M, H, W) GT thing masks upsampled to the input size and
    binarised (> 0), f32: the reference's form of the track-head masks."""
    return (resize_bilinear(gt.thing_masks, pad_hw) > 0).float()


def gt_track_boxes(gt: GTSample, pad_hw) -> torch.Tensor:
    """(B, M, 4) MAD boxes of the binarised upsampled GT masks, bit-equal to
    ``masks_to_boxes_mad`` of :func:`gt_track_masks` over the same (B * M)
    masks, from the exact support marginals at stride 4."""
    b, m = gt.thing_masks.shape[:2]
    rowcount, colcount = upsampled_support_marginals(gt.thing_masks.flatten(0, 1), pad_hw)
    return boxes_mad_from_marginals(rowcount, colcount).reshape(b, m, 4)


def _cat_gt(a: GTSample, b: GTSample) -> GTSample:
    return GTSample(*(torch.cat([x, y]) for x, y in zip(a, b)))


def track_losses(model: PolyphonicFormer, cfg, batch: TrainBatch, key_feats, ref_feats
                 ) -> Dict[str, torch.Tensor]:
    """The track losses of a 2-frame batch from both frames' FPN features:
    key and ref through one track-head call (its layers are per sample),
    the GT boxes of both from one marginal computation."""
    with span("train/track_losses"):
        b = batch.image.shape[0]
        both_gt = _cat_gt(batch.gt, batch.ref_gt)
        pair_feats = [torch.cat([k, r]) for k, r in zip(key_feats, ref_feats)]
        embeds = model.forward_track_embeds(
            pair_feats, None, both_gt.thing_valid,
            boxes=gt_track_boxes(both_gt, batch.image.shape[1:3]))
        return track_pair_losses(cfg, embeds[:b], embeds[b:], batch.gt, batch.ref_gt)


def video_forward_losses(model: PolyphonicFormer, cfg, batch: TrainBatch
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 2-frame training forward and loss: (total, loss dict).  ``cfg``: a
    ``ModelConfig``; ``batch.image`` and ``ref_image`` normalised, in the
    model's dtype."""
    key_feats = model.extract_feat(batch.image)
    total, losses = compute_losses(cfg, model.forward_heads(key_feats), batch.gt)
    with torch.no_grad():
        ref_feats = model.extract_feat(batch.ref_image)
    track = track_losses(model, cfg, batch, key_feats, ref_feats)
    losses.update(track)
    return total + (track["loss_track"] + track["loss_track_aux"]), losses
