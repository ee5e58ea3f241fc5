"""Streaming inference: one step per frame carrying the tracker state on the
device; mirrors ``polyphonicformer_tpu/infer/pipeline.py``.

Per frame: network -> x2 upsample of the last stage's mask and depth logits
(K2) -> fusion (K3 on the bf16 path) -> tight and MAD boxes from the
fusion's marginals -> RoIAlign track embeddings -> tracker -> the four maps
(K4).  PyTorch runs eagerly, so ``make_*_step`` bind their arguments and
``clip_video_step`` is a Python loop over the frames.  ``batched_video_step``
is not ported yet.
"""
from __future__ import annotations

import copy
import functools
from typing import NamedTuple, Tuple

import torch

from ..models.polyphonic import PolyphonicFormer
from ..ops.cuda.map_render import render_maps
from ..ops.resize import resize_bilinear
from ..ops.roi_align import boxes_mad_from_marginals
from .panoptic import PanopticResult, fuse_panoptic
from .tracker import TrackerState, tracker_step


class FrameOutput(NamedTuple):
    semantic: torch.Tensor  # (H, W) int32
    track_map: torch.Tensor  # (H, W) int32, 0 = no instance
    depth: torch.Tensor  # (H, W) float32
    depth_basic: torch.Tensor  # (H, W) float32
    panoptic: torch.Tensor  # (H, W) int32 segment ids
    pano: PanopticResult
    track_overflow: torch.Tensor  # () int32 kept things beyond max_detections


class ClipOutput(NamedTuple):
    semantic: torch.Tensor  # (T, H, W) int32
    track_map: torch.Tensor  # (T, H, W) int32
    depth: torch.Tensor  # (T, H, W) float32
    panoptic: torch.Tensor  # (T, H, W) int32
    track_overflow: torch.Tensor  # (T,) int32


def cast_model(model: PolyphonicFormer, dtype: torch.dtype) -> PolyphonicFormer:
    """The model in ``dtype``: itself if it already is, else a cast copy
    (weights and BN statistics, as the JAX package casts its variables)."""
    if next(model.parameters()).dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


def _tight_boxes_from_any(any_y: torch.Tensor, any_x: torch.Tensor) -> torch.Tensor:
    """Exact (y1, x1, y2, x2) boxes from row / column occupancy; empty rows
    give (-1, -1, 10, 10) as the JAX package does."""
    h, w = any_y.shape[1], any_x.shape[1]
    dev = any_y.device
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)
    big = torch.full((), 1 << 30, device=dev)
    neg = torch.full((), -1, device=dev)
    x1 = torch.where(any_x, xs, big).amin(dim=1)
    x2 = torch.where(any_x, xs, neg).amax(dim=1)
    y1 = torch.where(any_y, ys, big).amin(dim=1)
    y2 = torch.where(any_y, ys, neg).amax(dim=1)
    box = torch.stack([y1, x1, y2, x2], dim=1).float()
    empty_box = torch.full_like(box, 10.0)
    empty_box[:, :2] = -1.0
    return torch.where(~any_x.any(dim=1)[:, None], empty_box, box)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def _heads(model, image, compute_dtype):
    """Network forward in ``compute_dtype``; the outputs come back in f32."""
    model = cast_model(model, compute_dtype)
    fpn = model.extract_feat(image.to(compute_dtype))
    out = model.forward_heads(fpn)
    last = out.stages[-1]
    cls_probs = torch.sigmoid(last.cls_score[0].float())
    mask_logits = _upsample2(last.mask_preds[0].float())
    depth_logits = _upsample2(last.depth_preds[0].float())
    depth_init = _upsample2(out.rpn.depth_pred[0:1].float())[0]
    return model, fpn, cls_probs, mask_logits, depth_logits, depth_init


@torch.no_grad()
def video_frame_step(model: PolyphonicFormer, cfg, image: torch.Tensor,
                     tracker_state: TrackerState, frame_id, out_hw: Tuple[int, int],
                     compute_dtype=torch.float32, fusion_dtype=torch.float32
                     ) -> Tuple[FrameOutput, TrackerState]:
    """image: (1, H, W, 3) normalized and padded; out_hw: original size.
    compute_dtype bfloat16 runs the network in bf16; the tracker runs in
    f32.  fusion_dtype bfloat16 takes the K3 fusion kernel."""
    model, fpn, cls_probs, mask_logits, depth_logits, depth_init = _heads(
        model, image, compute_dtype)
    dev = cls_probs.device
    frame_id = frame_id.to(dev, torch.int32) if torch.is_tensor(frame_id) \
        else torch.full((), frame_id, dtype=torch.int32, device=dev)
    pano = fuse_panoptic(cfg, cls_probs, mask_logits, depth_logits, depth_init, out_hw,
                         fusion_dtype=fusion_dtype, emit_marginals=True, defer_maps=True)

    # tracking over kept thing segments, from the fusion's marginals
    d = cfg.tracker.max_detections
    kk = pano.instance_ids.shape[0]
    take = min(d, kk)

    def to_d(arr):
        out = arr.new_zeros((d,) + arr.shape[1:])
        out[:take] = arr[:take]
        return out

    thing_keep = pano.keep & pano.is_thing
    det_valid = to_d(thing_keep)
    det_scores = to_d(pano.scores)
    det_labels = to_d(pano.labels)
    det_rowm = to_d(pano.row_marg) * det_valid[:, None]
    det_colm = to_d(pano.col_marg) * det_valid[:, None]
    boxes_yx = _tight_boxes_from_any(det_rowm > 0, det_colm > 0)
    det_boxes = torch.cat([boxes_yx.clamp(min=0.0), det_scores[:, None]], dim=1)
    roi_boxes = boxes_mad_from_marginals(det_rowm, det_colm)
    embeds = model.forward_track_embeds(fpn, roi_boxes[None], det_valid[None])[0].float()

    new_state, ids_sorted, order, kept_sorted = tracker_step(
        cfg.tracker, tracker_state, det_boxes, det_labels, embeds, det_valid, frame_id)
    # sorted ids back to candidate order; reference: ids + 1, -1 / -2 -> 0
    ids_by_det = torch.zeros((d,), dtype=torch.int32, device=dev)
    ids_by_det[order] = torch.where(kept_sorted & (ids_sorted >= 0), ids_sorted + 1,
                                    torch.zeros_like(ids_sorted))
    overflow = (thing_keep.sum() - thing_keep[:take].sum()).to(torch.int32)
    cand_track_id = torch.zeros((kk,), dtype=torch.int32, device=dev)
    cand_track_id[:take] = ids_by_det[:take]
    ids_full = cand_track_id * thing_keep.to(torch.int32)

    nr = kk if pano.n_render is None else pano.n_render
    semantic, panoptic, depth, track_map = render_maps(
        pano.pix_arg, pano.depth_pix, pano.depth_basic, pano.labels[:nr],
        pano.seg_ids[:nr], pano.keep[:nr], ids_full[:nr], cfg.num_classes)
    pano = pano._replace(semantic=semantic, panoptic=panoptic, depth=depth)
    return FrameOutput(semantic=semantic, track_map=track_map, depth=depth,
                       depth_basic=pano.depth_basic, panoptic=panoptic, pano=pano,
                       track_overflow=overflow), new_state


def make_video_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                    fusion_dtype=torch.float32):
    """step(image, tracker_state, frame_id) -> (FrameOutput, TrackerState)."""
    return functools.partial(video_frame_step, cast_model(model, compute_dtype), cfg,
                             out_hw=tuple(out_hw), compute_dtype=compute_dtype,
                             fusion_dtype=fusion_dtype)


@torch.no_grad()
def clip_video_step(model: PolyphonicFormer, cfg, images: torch.Tensor,
                    tracker_state: TrackerState, first_frame_id, out_hw: Tuple[int, int],
                    compute_dtype=torch.float32, fusion_dtype=torch.float32
                    ) -> Tuple[ClipOutput, TrackerState]:
    """T consecutive frames of one sequence, in order through the stateful
    tracker.  images: (T, H, W, 3)."""
    model = cast_model(model, compute_dtype)  # once, not per frame
    outs = []
    state = tracker_state
    for t in range(images.shape[0]):
        fo, state = video_frame_step(model, cfg, images[t:t + 1], state,
                                     first_frame_id + t, out_hw,
                                     compute_dtype=compute_dtype, fusion_dtype=fusion_dtype)
        outs.append(fo)
    return ClipOutput(
        semantic=torch.stack([o.semantic for o in outs]),
        track_map=torch.stack([o.track_map for o in outs]),
        depth=torch.stack([o.depth for o in outs]),
        panoptic=torch.stack([o.panoptic for o in outs]),
        track_overflow=torch.stack([o.track_overflow for o in outs])), state


def make_clip_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                   fusion_dtype=torch.float32):
    """step(images, tracker_state, first_frame_id) -> (ClipOutput, TrackerState)."""
    return functools.partial(clip_video_step, cast_model(model, compute_dtype), cfg,
                             out_hw=tuple(out_hw), compute_dtype=compute_dtype,
                             fusion_dtype=fusion_dtype)


def make_image_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                    fusion_dtype=torch.float32):
    """Image-mode inference, step(image) -> PanopticResult with the maps."""
    model = cast_model(model, compute_dtype)
    kernel_path = fusion_dtype != torch.float32

    @torch.no_grad()
    def step(image: torch.Tensor) -> PanopticResult:
        _, _, cls_probs, mask_logits, depth_logits, depth_init = _heads(
            model, image, compute_dtype)
        return fuse_panoptic(cfg, cls_probs, mask_logits, depth_logits, depth_init,
                             tuple(out_hw), fusion_dtype=fusion_dtype,
                             emit_marginals=kernel_path)

    return step
