"""Quasi-dense embedding tracker as a fixed-capacity state machine on the
device; mirrors ``polyphonicformer_tpu/infer/tracker.py`` (see its module
note for the semantics kept from the reference).

Every sort is stable (``jnp.argsort`` is): invalid detections carry a
``-inf`` key and tie.  The greedy assignment is a Python loop over the D
detections of device ops that never reads a value back to the host.  This
is the plain version of ``ops/cuda/tracker.py`` (K9), which serving calls:
one kernel launch for the tracker steps of all clips on a card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_NEG = -1e30


@dataclasses.dataclass
class TrackerState:
    ids: torch.Tensor  # (T,) int32 track id, -1 = free slot
    embeds: torch.Tensor  # (T, E)
    bboxes: torch.Tensor  # (T, 5) x1, y1, x2, y2, score
    labels: torch.Tensor  # (T,) int32
    last_frame: torch.Tensor  # (T,) int32
    velocities: torch.Tensor  # (T, 5)
    acc_frames: torch.Tensor  # (T,) int32
    num_tracklets: torch.Tensor  # () int32, next fresh id
    bd_embeds: torch.Tensor  # (BD, E) backdrops, newest block first
    bd_bboxes: torch.Tensor  # (BD, 5)
    bd_labels: torch.Tensor  # (BD,) int32
    bd_valid: torch.Tensor  # (BD,) bool

    def replace(self, **changes) -> "TrackerState":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "TrackerState":
        """``fn`` applied to every field."""
        return TrackerState(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


def init_tracker_state(cfg, embed_dim: int, device="cuda") -> TrackerState:
    """cfg: a ``TrackerConfig``."""
    t, d = cfg.max_tracklets, cfg.max_detections
    bd = d * cfg.memo_backdrop_frames
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackerState(
        ids=torch.full((t,), -1, **i32), embeds=torch.zeros((t, embed_dim), **f32),
        bboxes=torch.zeros((t, 5), **f32), labels=torch.zeros((t,), **i32),
        last_frame=torch.zeros((t,), **i32), velocities=torch.zeros((t, 5), **f32),
        acc_frames=torch.zeros((t,), **i32), num_tracklets=torch.zeros((), **i32),
        bd_embeds=torch.zeros((bd, embed_dim), **f32), bd_bboxes=torch.zeros((bd, 5), **f32),
        bd_labels=torch.zeros((bd,), **i32),
        bd_valid=torch.zeros((bd,), dtype=torch.bool, device=device))


def bbox_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mmdet-style IoU. a: (N, 4+), b: (M, 4+). Returns (N, M)."""
    iw = torch.clamp(torch.minimum(a[:, None, 2], b[None, :, 2])
                     - torch.maximum(a[:, None, 0], b[None, :, 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[:, None, 3], b[None, :, 3])
                     - torch.maximum(a[:, None, 1], b[None, :, 1]), min=0.0)
    inter = iw * ih
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0.0) * torch.clamp(a[:, 3] - a[:, 1], min=0.0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0.0) * torch.clamp(b[:, 3] - b[:, 1], min=0.0)
    union = area_a[:, None] + area_b[None] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _scatter_rows(arr: torch.Tensor, slot: torch.Tensor, sel: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Rows ``slot[i]`` of ``arr`` set to ``vals[i]`` where ``sel[i]``;
    slot == len(arr) is an overflow row that is dropped."""
    ext = torch.cat([arr, torch.zeros_like(arr[:1])])
    sel = sel.reshape((-1,) + (1,) * (vals.dim() - 1))
    ext[slot] = torch.where(sel, vals.to(ext.dtype), ext[slot])
    return ext[:-1]


def tracker_step(cfg, state: TrackerState, bboxes: torch.Tensor, labels: torch.Tensor,
                 embeds: torch.Tensor, det_valid: torch.Tensor, frame_id: torch.Tensor
                 ) -> Tuple[TrackerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frame.  bboxes (D, 5) with the score in column 4; labels (D,);
    embeds (D, E); det_valid (D,) bool; frame_id () int32.

    Returns (new_state, ids (D,), order (D,), kept (D,)) in score order;
    ``order`` maps sorted position -> input index; ids: >= 0 track id,
    -1 unmatched, -2 suppressed.
    """
    d = bboxes.shape[0]
    t = cfg.max_tracklets
    dev = bboxes.device

    sort_key = torch.where(det_valid, bboxes[:, 4], torch.full_like(bboxes[:, 4], -torch.inf))
    order = torch.argsort(-sort_key, stable=True)
    bboxes, labels, embeds, det_valid = bboxes[order], labels[order], embeds[order], det_valid[order]

    # intra-frame duplicate removal against every higher-scored detection
    ious_dd = bbox_iou(bboxes, bboxes)
    tri = torch.tril(torch.ones((d, d), dtype=torch.bool, device=dev), diagonal=-1)
    thr = torch.where(bboxes[:, 4] < cfg.obj_score_thr,
                      torch.full_like(bboxes[:, 4], cfg.nms_backdrop_iou_thr),
                      torch.full_like(bboxes[:, 4], cfg.nms_class_iou_thr))
    dup = ((ious_dd > thr[:, None]) & tri & det_valid[None, :]).any(dim=1)
    det_valid = det_valid & ~dup

    memo_embeds = torch.cat([state.embeds, state.bd_embeds])
    memo_labels = torch.cat([state.labels, state.bd_labels])
    memo_ids = torch.cat([state.ids, torch.full((state.bd_embeds.shape[0],), -1,
                                                dtype=torch.int32, device=dev)])
    memo_valid = torch.cat([state.ids >= 0, state.bd_valid])

    feats = embeds @ memo_embeds.t()
    col_mask = memo_valid[None, :]
    row_mask = det_valid[:, None]
    neg = torch.full_like(feats, _NEG)
    if cfg.match_metric == "bisoftmax":
        d2t = torch.softmax(torch.where(col_mask, feats, neg), dim=1)
        t2d = torch.softmax(torch.where(row_mask, feats, neg), dim=0)
        scores_mat = (d2t + t2d) / 2.0
    elif cfg.match_metric == "softmax":
        scores_mat = torch.softmax(torch.where(col_mask, feats, neg), dim=1)
    else:  # cosine
        en = embeds / torch.clamp(embeds.norm(dim=1, keepdim=True), min=1e-12)
        mn = memo_embeds / torch.clamp(memo_embeds.norm(dim=1, keepdim=True), min=1e-12)
        scores_mat = en @ mn.t()
    if cfg.with_cats:
        scores_mat = scores_mat * (labels[:, None] == memo_labels[None, :])
    scores_mat = torch.where(col_mask & row_mask, scores_mat, torch.zeros_like(scores_mat))
    has_memo = memo_valid.any()

    # greedy assignment with column suppression, in score order
    det_scores = bboxes[:, 4]
    cols = torch.arange(scores_mat.shape[1], device=dev)
    used = torch.zeros((scores_mat.shape[1],), dtype=torch.bool, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    minus2 = torch.full((), -2, dtype=torch.int32, device=dev)
    ids = torch.empty((d,), dtype=torch.int32, device=dev)
    for i in range(d):
        # (1,)-shaped indices and slices throughout: indexing with a 0-dim
        # tensor would read it back to the host and stall the stream
        row = torch.where(used, torch.zeros_like(scores_mat[i]), scores_mat[i])
        memo_ind = torch.argmax(row).reshape(1)
        conf = row[memo_ind]
        tid = memo_ids[memo_ind]
        confident = (conf > cfg.match_score_thr) & det_valid[i:i + 1] & has_memo
        matched = confident & (tid > -1)
        take = matched & (det_scores[i:i + 1] > cfg.obj_score_thr)
        suppress = matched & (det_scores[i:i + 1] <= cfg.obj_score_thr) \
            & (conf > cfg.nms_conf_thr)
        ids[i:i + 1] = torch.where(take, tid, torch.where(suppress, minus2, minus1))
        used = used | (take & (cols == memo_ind))

    # new ids for confident unmatched detections
    new_mask = (ids == -1) & (det_scores > cfg.init_score_thr) & det_valid
    new_rank = torch.cumsum(new_mask.to(torch.int32), dim=0) - 1
    ids = torch.where(new_mask, (state.num_tracklets + new_rank).to(torch.int32), ids)
    num_tracklets = state.num_tracklets + new_mask.sum().to(torch.int32)

    # existing tracklets: EMA update by id
    tracked = ids > -1
    same = ids[:, None] == state.ids[None, :]
    slot_of_det = torch.argmax(same.to(torch.int32), dim=1)
    in_table = same.any(dim=1) & tracked
    slot = torch.where(in_table, slot_of_det, torch.full_like(slot_of_det, t))
    cs = slot.clamp(0, t - 1)
    dt = torch.clamp(frame_id - state.last_frame[cs], min=1)
    vel = (bboxes - state.bboxes[cs]) / dt[:, None]
    new_emb = (1 - cfg.memo_momentum) * state.embeds[cs] + cfg.memo_momentum * embeds
    old_acc = state.acc_frames[cs]
    new_v = (state.velocities[cs] * old_acc[:, None] + vel) / (old_acc[:, None] + 1)
    frames = torch.full((d,), 0, dtype=torch.int32, device=dev) + frame_id
    state = state.replace(
        bboxes=_scatter_rows(state.bboxes, slot, in_table, bboxes),
        embeds=_scatter_rows(state.embeds, slot, in_table, new_emb),
        labels=_scatter_rows(state.labels, slot, in_table, labels),
        last_frame=_scatter_rows(state.last_frame, slot, in_table, frames),
        velocities=_scatter_rows(state.velocities, slot, in_table, new_v),
        acc_frames=_scatter_rows(state.acc_frames, slot, in_table, old_acc + 1))

    # new tracklets into free slots (free slots first, stable)
    is_new = tracked & ~in_table
    free_order = torch.argsort((state.ids >= 0).to(torch.int32), stable=True)
    new_rank2 = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
    target = torch.where(is_new, free_order[new_rank2.clamp(0, t - 1)],
                         torch.full((d,), t, dtype=free_order.dtype, device=dev))
    state = state.replace(
        ids=_scatter_rows(state.ids, target, is_new, ids),
        bboxes=_scatter_rows(state.bboxes, target, is_new, bboxes),
        embeds=_scatter_rows(state.embeds, target, is_new, embeds),
        labels=_scatter_rows(state.labels, target, is_new, labels),
        last_frame=_scatter_rows(state.last_frame, target, is_new, frames),
        velocities=_scatter_rows(state.velocities, target, is_new, torch.zeros_like(bboxes)),
        acc_frames=_scatter_rows(state.acc_frames, target, is_new, torch.zeros_like(frames)),
        num_tracklets=num_tracklets)

    # backdrops: unmatched detections not overlapping a higher-ranked one
    bd_keep = (ids == -1) & det_valid & ~(
        (ious_dd > cfg.nms_backdrop_iou_thr) & tri & det_valid[None, :]).any(dim=1)
    state = state.replace(
        bd_embeds=torch.cat([embeds * bd_keep[:, None], state.bd_embeds[:-d]]),
        bd_bboxes=torch.cat([bboxes * bd_keep[:, None], state.bd_bboxes[:-d]]),
        bd_labels=torch.cat([torch.where(bd_keep, labels, torch.full_like(labels, -999)),
                             state.bd_labels[:-d]]),
        bd_valid=torch.cat([bd_keep, state.bd_valid[:-d]]))

    # expire stale tracklets
    expired = (state.ids >= 0) & (frame_id - state.last_frame >= cfg.memo_tracklet_frames)
    state = state.replace(ids=torch.where(expired, torch.full_like(state.ids, -1), state.ids))
    return state, ids, order, det_valid
