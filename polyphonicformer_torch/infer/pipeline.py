"""Streaming inference: one step per frame carrying the tracker state on the
device; mirrors ``polyphonicformer_tpu/infer/pipeline.py``.

Per frame: network -> x2 upsample of the last stage's mask and depth logits
(K2) -> fusion (K3 on the bf16 path) -> tight and MAD boxes from the
fusion's marginals -> RoIAlign track embeddings -> tracker (K9) -> the four
maps (K4).  PyTorch runs eagerly, so ``make_*_step`` bind their arguments
and ``clip_video_step`` is a Python loop over the frames.
``batched_video_step`` serves one frame of each of B clips: one batched
network forward, fusion and detections per clip, one batched track head,
one tracker step for all clips, the maps per clip.  Over the data ranks of a mesh
(:func:`make_sharded_batched_video_step`) each rank serves its part of the
clips with the same weights and its own tracker states, and
:func:`gather_frame_outputs` gathers the outputs in clip order.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import NamedTuple, Tuple

import torch

from ..models.polyphonic import PolyphonicFormer
from ..ops.cuda.map_render import render_maps
from ..ops.cuda.tracker import tracker_step_batched
from ..ops.resize import resize_bilinear
from ..ops.roi_align import boxes_mad_from_marginals
from ..utils.profiling import span
from .panoptic import PanopticResult, fuse_panoptic
from .tracker import TrackerState, init_tracker_state


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


class _Heads(NamedTuple):
    """The last stage's outputs for fusion, one row per image, f32."""
    cls_probs: torch.Tensor  # (B, Q, C) sigmoid probabilities
    mask_logits: torch.Tensor  # (B, Q, h, w) at stride 4
    depth_logits: torch.Tensor  # (B, Q, h, w)
    depth_init: torch.Tensor  # (B, h, w) the rpn's dense depth logits


def _heads(model, images, compute_dtype):
    """Network forward over the batch in ``compute_dtype``; the outputs come
    back in f32, each x2 upsample one launch for the whole batch."""
    with span("serve/network"):
        model = cast_model(model, compute_dtype)
        fpn = model.extract_feat(images.to(compute_dtype))
        out = model.forward_heads(fpn, with_aspp=False)
        last = out.stages[-1]
        return model, fpn, _Heads(
            cls_probs=torch.sigmoid(last.cls_score.float()),
            mask_logits=_upsample2(last.mask_preds.float()),
            depth_logits=_upsample2(last.depth_preds.float()),
            depth_init=_upsample2(out.rpn.depth_pred.float()))


def _fuse(cfg, heads: _Heads, b: int, out_hw, fusion_dtype, **kw) -> PanopticResult:
    with span("serve/fuse"):
        return fuse_panoptic(cfg, heads.cls_probs[b], heads.mask_logits[b],
                             heads.depth_logits[b], heads.depth_init[b], out_hw,
                             fusion_dtype=fusion_dtype, **kw)


class _Detections(NamedTuple):
    """The tracker's D candidate rows, from the fusion's marginals."""
    thing_keep: torch.Tensor  # (K,) kept thing segments
    valid: torch.Tensor  # (D,)
    labels: torch.Tensor  # (D,)
    boxes: torch.Tensor  # (D, 5) tight (y1, x1, y2, x2) and the score
    roi_boxes: torch.Tensor  # (D, 4) MAD boxes for the track head


def _detections(cfg, pano: PanopticResult) -> _Detections:
    d = cfg.tracker.max_detections
    take = min(d, pano.instance_ids.shape[0])

    def to_d(arr):
        out = arr.new_zeros((d,) + arr.shape[1:])
        out[:take] = arr[:take]
        return out

    with span("serve/detections"):
        thing_keep = pano.keep & pano.is_thing
        det_valid = to_d(thing_keep)
        det_rowm = to_d(pano.row_marg) * det_valid[:, None]
        det_colm = to_d(pano.col_marg) * det_valid[:, None]
        boxes_yx = _tight_boxes_from_any(det_rowm > 0, det_colm > 0)
        return _Detections(
            thing_keep=thing_keep, valid=det_valid, labels=to_d(pano.labels),
            boxes=torch.cat([boxes_yx.clamp(min=0.0), to_d(pano.scores)[:, None]], dim=1),
            roi_boxes=boxes_mad_from_marginals(det_rowm, det_colm))


def _frame_ids(frame_ids, dev) -> torch.Tensor:
    """(B,) int32 frame ids on ``dev``.  Host values reach a card by one
    copy from pinned memory, which does not wait for the card."""
    ids = torch.as_tensor(frame_ids).to(torch.int32)
    if ids.device.type == "cpu" and dev.type == "cuda":
        ids = ids.pin_memory()
    return ids.to(dev, non_blocking=True)


def _track_and_render(cfg, panos, dets, embeds: torch.Tensor, tracker_states: TrackerState,
                      frame_ids: torch.Tensor) -> Tuple[list, TrackerState]:
    """The tracker step of all B clips at once (``poly::tracker_step``: one
    kernel launch on a card), then each clip's four maps (K4).  panos, dets:
    B per-clip results; embeds (B, D, E); tracker_states with a leading clip
    axis; frame_ids (B,) int32.  Returns the B FrameOutputs and the new
    states, stacked."""
    d = cfg.tracker.max_detections
    kk = panos[0].instance_ids.shape[0]
    take = min(d, kk)
    with span("serve/track"):
        new_states, ids_sorted, order, kept_sorted = tracker_step_batched(
            cfg.tracker, tracker_states, torch.stack([det.boxes for det in dets]),
            torch.stack([det.labels for det in dets]), embeds,
            torch.stack([det.valid for det in dets]), frame_ids)
        # sorted ids back to candidate order; reference: ids + 1, -1 / -2 -> 0
        ids_by_det = torch.zeros_like(ids_sorted).scatter_(
            1, order, torch.where(kept_sorted & (ids_sorted >= 0), ids_sorted + 1,
                                  torch.zeros_like(ids_sorted)))
        thing_keep = torch.stack([det.thing_keep for det in dets])
        overflow = (thing_keep.sum(1) - thing_keep[:, :take].sum(1)).to(torch.int32)
        cand_track_id = torch.zeros(thing_keep.shape, dtype=torch.int32, device=embeds.device)
        cand_track_id[:, :take] = ids_by_det[:, :take]
        ids_full = cand_track_id * thing_keep.to(torch.int32)

    outs = []
    for b, pano in enumerate(panos):
        nr = kk if pano.n_render is None else pano.n_render
        with span("serve/render"):
            semantic, panoptic, depth, track_map = render_maps(
                pano.pix_arg, pano.depth_pix, pano.depth_basic, pano.labels[:nr],
                pano.seg_ids[:nr], pano.keep[:nr], ids_full[b, :nr], cfg.num_classes)
        pano = pano._replace(semantic=semantic, panoptic=panoptic, depth=depth)
        outs.append(FrameOutput(semantic=semantic, track_map=track_map, depth=depth,
                                depth_basic=pano.depth_basic, panoptic=panoptic, pano=pano,
                                track_overflow=overflow[b]))
    return outs, new_states


@torch.no_grad()
def video_frame_step(model: PolyphonicFormer, cfg, image: torch.Tensor,
                     tracker_state: TrackerState, frame_id, out_hw: Tuple[int, int],
                     compute_dtype=torch.float32, fusion_dtype=torch.float32
                     ) -> Tuple[FrameOutput, TrackerState]:
    """image: (1, H, W, 3) normalized and padded; out_hw: original size.
    compute_dtype bfloat16 runs the network in bf16; the tracker runs in
    f32.  fusion_dtype bfloat16 takes the K3 fusion kernel."""
    with span("serve/step"):
        model, fpn, heads = _heads(model, image, compute_dtype)
        pano = _fuse(cfg, heads, 0, out_hw, fusion_dtype, emit_marginals=True,
                     defer_maps=True)
        det = _detections(cfg, pano)
        with span("serve/track_embeds"):
            embeds = model.forward_track_embeds(fpn, None, det.valid[None],
                                                boxes=det.roi_boxes[None])[0].float()
        outs, new_states = _track_and_render(
            cfg, [pano], [det], embeds[None], tracker_state.map(lambda x: x[None]),
            _frame_ids(frame_id, embeds.device).reshape(1))
        return outs[0], new_states.map(lambda x: x[0])


def make_video_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                    fusion_dtype=torch.float32):
    """step(image, tracker_state, frame_id) -> (FrameOutput, TrackerState)."""
    return functools.partial(video_frame_step, cast_model(model, compute_dtype), cfg,
                             out_hw=tuple(out_hw), compute_dtype=compute_dtype,
                             fusion_dtype=fusion_dtype)


def _stack(items):
    """Per-clip results -> one result with a leading clip axis; a field that
    is None or a static int is the same for every clip and kept as it is."""
    first = items[0]
    if torch.is_tensor(first):
        return torch.stack(items)
    if isinstance(first, TrackerState):
        return TrackerState(**{f.name: torch.stack([getattr(s, f.name) for s in items])
                               for f in dataclasses.fields(TrackerState)})
    if isinstance(first, tuple):  # a NamedTuple of results
        return type(first)(*(_stack(list(field)) for field in zip(*items)))
    return first


def init_batched_tracker_states(cfg, batch: int, device="cuda") -> TrackerState:
    """``batch`` fresh tracker states, each field with a leading clip axis."""
    one = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, device)
    return _stack([one] * batch)


@torch.no_grad()
def batched_video_step(model: PolyphonicFormer, cfg, images: torch.Tensor,
                       tracker_states: TrackerState, frame_ids, out_hw: Tuple[int, int],
                       compute_dtype=torch.float32, fusion_dtype=torch.float32
                       ) -> Tuple[FrameOutput, TrackerState]:
    """Multi-clip serving (BASELINE.json config #5): B frames of B
    independent sequences, one per clip.  images (B, H, W, 3);
    tracker_states from :func:`init_batched_tracker_states` or the last
    call; frame_ids (B,) ints or an int tensor.

    One batched network forward; fusion and boxes per clip (JAX ``vmap``s
    them); one batched track-head forward; one tracker step for all clips,
    each clip's tracker state its own.  Returns the FrameOutput and TrackerState
    with a leading clip axis."""
    with span("serve/step"):
        model, fpn, heads = _heads(model, images, compute_dtype)
        batch = images.shape[0]
        panos = [_fuse(cfg, heads, b, out_hw, fusion_dtype, emit_marginals=True,
                       defer_maps=True) for b in range(batch)]
        dets = [_detections(cfg, pano) for pano in panos]
        with span("serve/track_embeds"):
            embeds = model.forward_track_embeds(
                fpn, None, torch.stack([d.valid for d in dets]),
                boxes=torch.stack([d.roi_boxes for d in dets])).float()
        outs, states = _track_and_render(cfg, panos, dets, embeds, tracker_states,
                                         _frame_ids(frame_ids, embeds.device))
        with span("serve/stack"):
            return _stack(outs), states


def make_batched_video_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                            fusion_dtype=torch.float32):
    """step(images, tracker_states, frame_ids) -> (FrameOutput, TrackerState),
    batched over clips."""
    return functools.partial(batched_video_step, cast_model(model, compute_dtype), cfg,
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


@torch.no_grad()
def image_step(model: PolyphonicFormer, cfg, image: torch.Tensor, out_hw: Tuple[int, int],
               compute_dtype=torch.float32, fusion_dtype=torch.float32) -> PanopticResult:
    """Image-mode inference of image (1, H, W, 3): the PanopticResult with
    the maps."""
    with span("serve/step"):
        _, _, heads = _heads(model, image, compute_dtype)
        return _fuse(cfg, heads, 0, tuple(out_hw), fusion_dtype,
                     emit_marginals=fusion_dtype != torch.float32)


def make_image_step(model: PolyphonicFormer, cfg, out_hw, compute_dtype=torch.float32,
                    fusion_dtype=torch.float32):
    """Image-mode inference, step(image) -> PanopticResult with the maps."""
    return functools.partial(image_step, cast_model(model, compute_dtype), cfg,
                             out_hw=tuple(out_hw), compute_dtype=compute_dtype,
                             fusion_dtype=fusion_dtype)


def make_sharded_batched_video_step(model: PolyphonicFormer, cfg, out_hw, mesh,
                                    compute_dtype=torch.float32, fusion_dtype=torch.float32):
    """:func:`make_batched_video_step` of one data rank of ``mesh`` (the JAX
    package's mesh-sharded ``batched_video_step``): the weights come from
    data index 0 first, so every rank serves the same model; then
    step(images, tracker_states, frame_ids) takes the global batch of
    images and frame ids, serves this rank's clips
    (``parallel.mesh.local_slice``) with this rank's tracker states
    (``init_batched_tracker_states`` of the local clip count) and returns
    this rank's (FrameOutput, TrackerState)."""
    from ..parallel.mesh import broadcast_module, local_slice

    broadcast_module(model, mesh.data_group)
    step = make_batched_video_step(model, cfg, out_hw, compute_dtype, fusion_dtype)

    def sharded(images, tracker_states, frame_ids):
        return step(local_slice(images, mesh), tracker_states,
                    local_slice(torch.as_tensor(frame_ids), mesh))

    return sharded


def gather_frame_outputs(out: FrameOutput, mesh) -> FrameOutput:
    """Every rank's FrameOutput (leading clip axis, the same clip count on
    every data rank) on every rank, concatenated in clip order."""
    from ..parallel.mesh import all_gather

    def gather(x):
        if torch.is_tensor(x):
            return all_gather(x, mesh.data_group).flatten(0, 1)
        if isinstance(x, tuple):
            return type(x)(*(gather(v) for v in x))
        return x

    return gather(out)
