"""The serving tracker's step for every clip of a serving step, K9.

Replaces no Pallas kernel: the JAX package leaves its tracker
(``polyphonicformer_tpu/infer/tracker.py::tracker_step``) to XLA inside
``jit``.  Eagerly, the plain version is ~1,650 launches of tiny ops a clip,
each paced by the host; the CUDA kernel (``csrc/tracker.cu``; the source
note there gives the bound and the design) is the whole step of all B clips
in one launch, one thread block a clip, its float state bit-equal to the
plain version's.  The plain version, :func:`tracker_step_plain`, is
``infer/tracker.py::tracker_step`` looped over the clips.  The entry is the
custom op ``poly::tracker_step``; :func:`tracker_step_batched` checks the
inputs and takes and gives a stacked ``TrackerState``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ...configs import TrackerConfig
from ...infer.tracker import TrackerState, tracker_step
from . import _lib

KERNEL = _lib.Kernel("poly_tracker_step", [_lib.P, _lib.P, _lib.P])

METRICS = ("bisoftmax", "softmax", "cosine")  # the kernel's metric codes, in order
THRESHOLDS = ("init_score_thr", "obj_score_thr", "match_score_thr", "memo_momentum",
              "nms_conf_thr", "nms_backdrop_iou_thr", "nms_class_iou_thr")
FIELDS = tuple(f.name for f in dataclasses.fields(TrackerState))
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_CW = 32  # memo rows a staged chunk (csrc/tracker.cu)


def smem_bytes(d: int, t: int, bd: int, e: int) -> int:
    """Shared memory of one clip's block, as ``carve`` in the source lays it
    out: f32 arrays (the valid rows' embeddings, two staged chunks of memo
    rows, the (D, T+BD) scores, the softmax statistics, the sorted boxes and
    keys), int32 arrays, then bytes, each rounded up to 16 bytes."""
    m = t + bd
    words = (d * e, 2 * _CW * (e + 4), d * m, d, d, m, m, 5 * d, d,
             d, d, d, d, d, t, t, t, t, m, m, 2)
    nbytes = (d, d, d, d * d, m)
    return sum(-(-4 * w // 16) * 16 for w in words) + sum(-(-n // 16) * 16 for n in nbytes)


def _dims(state, bboxes, labels, embeds, det_valid, frame_ids, match_metric) -> Tuple[int, ...]:
    """(B, D, T, BD, E) from the shapes; raises unless every tensor has the
    dtype, shape and device the op takes, E is a multiple of 4, the block's
    shared memory fits and the match metric is one of METRICS."""
    if len(state) != len(FIELDS):
        raise ValueError(f"tracker_step: {len(state)} state fields, expected {len(FIELDS)}")
    for name, x, nd in (("det_valid", det_valid, 2), ("ids", state[0], 2),
                        ("bd_valid", state[11], 2), ("det embeds", embeds, 3)):
        if x.dim() != nd:
            raise ValueError(f"tracker_step: {name} has {x.dim()} dims, expected {nd}")
    b, d = det_valid.shape
    t, bd, e = state[0].shape[1], state[11].shape[1], embeds.shape[2]
    i32, f32 = torch.int32, torch.float32
    want = {"ids": (i32, (b, t)), "embeds": (f32, (b, t, e)), "bboxes": (f32, (b, t, 5)),
            "labels": (i32, (b, t)), "last_frame": (i32, (b, t)),
            "velocities": (f32, (b, t, 5)), "acc_frames": (i32, (b, t)),
            "num_tracklets": (i32, (b,)), "bd_embeds": (f32, (b, bd, e)),
            "bd_bboxes": (f32, (b, bd, 5)), "bd_labels": (i32, (b, bd)),
            "bd_valid": (torch.bool, (b, bd))}
    named = list(zip(FIELDS, state)) + [
        ("det bboxes", bboxes), ("det labels", labels), ("det embeds", embeds),
        ("det_valid", det_valid), ("frame_ids", frame_ids)]
    want.update({"det bboxes": (f32, (b, d, 5)), "det labels": (i32, (b, d)),
                 "det embeds": (f32, (b, d, e)), "det_valid": (torch.bool, (b, d)),
                 "frame_ids": (i32, (b,))})
    for name, x in named:
        dtype, shape = want[name]
        if x.dtype != dtype:
            raise TypeError(f"tracker_step: {name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"tracker_step: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.device != det_valid.device:
            raise ValueError(f"tracker_step: {name} on {x.device}, det_valid on {det_valid.device}")
    if not 1 <= d <= min(t, bd) or t + bd > 256:
        raise ValueError(f"tracker_step: D = {d} detections, T = {t} tracklets, BD = {bd} "
                         f"backdrops: need 1 <= D <= T, D <= BD and T + BD <= 256")
    if e % 4:
        raise ValueError(f"tracker_step: E = {e} embedding channels, need a multiple of 4")
    if match_metric not in METRICS:
        raise ValueError(f"tracker_step: match_metric {match_metric!r} not in {METRICS}")
    if smem_bytes(d, t, bd, e) > SMEM_LIMIT:
        raise ValueError(f"tracker_step: D {d}, T {t}, BD {bd}, E {e} need "
                         f"{smem_bytes(d, t, bd, e)} bytes of shared memory a clip, "
                         f"more than {SMEM_LIMIT}")
    return b, d, t, bd, e


def _outputs(state, det_valid) -> list:
    """Fresh tensors for the new state, ids, order and kept."""
    dev = det_valid.device
    return ([torch.empty(x.shape, dtype=x.dtype, device=dev) for x in state]
            + [torch.empty(det_valid.shape, dtype=dt, device=dev)
               for dt in (torch.int32, torch.int64, torch.bool)])


def _config(thr, memo_tracklet_frames, with_cats, match_metric, t, d, bd) -> TrackerConfig:
    return TrackerConfig(**dict(zip(THRESHOLDS, thr)), memo_tracklet_frames=memo_tracklet_frames,
                         memo_backdrop_frames=bd // d, with_cats=with_cats,
                         match_metric=match_metric, max_tracklets=t, max_detections=d)


def tracker_step_plain(*args) -> list:
    """The op's contract in plain tensor ops: ``infer/tracker.py``'s
    ``tracker_step`` on each clip, the results stacked."""
    state, (bboxes, labels, embeds, det_valid, frame_ids, thr, memo_tracklet_frames, with_cats,
            match_metric) = args[:len(FIELDS)], args[len(FIELDS):]
    b, d, t, bd, _ = _dims(state, bboxes, labels, embeds, det_valid, frame_ids, match_metric)
    cfg = _config(thr, memo_tracklet_frames, with_cats, match_metric, t, d, bd)
    per_clip = []
    for i in range(b):
        new, ids, order, kept = tracker_step(cfg, TrackerState(*(x[i] for x in state)),
                                             bboxes[i], labels[i], embeds[i], det_valid[i],
                                             frame_ids[i])
        per_clip.append([*(getattr(new, n) for n in FIELDS), ids, order, kept])
    return [torch.stack(x) for x in zip(*per_clip)]


def _tracker_step_cuda(*args) -> list:
    state, (bboxes, labels, embeds, det_valid, frame_ids, thr, memo_tracklet_frames, with_cats,
            match_metric) = args[:len(FIELDS)], args[len(FIELDS):]
    b, d, t, bd, e = _dims(state, bboxes, labels, embeds, det_valid, frame_ids, match_metric)
    ins = args[:len(FIELDS) + 5]
    for name, x in zip(FIELDS + ("bboxes", "labels", "embeds", "det_valid", "frame_ids"), ins):
        _lib.check_cuda(name, x, (x.dtype,))
    for name, x in (("embeds", state[1]), ("bd_embeds", state[8]), ("det embeds", embeds)):
        if x.data_ptr() % 16:
            raise ValueError(f"tracker_step: {name} is not 16-byte aligned")
    outs = _outputs(state, det_valid)
    init, obj, match, momentum, conf, bd_iou, class_iou = thr
    ptrs = (ctypes.c_void_p * 32)(*(x.data_ptr() for x in (*ins, *outs)))
    ints = (ctypes.c_int * 8)(b, d, t, bd, e, memo_tracklet_frames, METRICS.index(match_metric),
                              int(with_cats))
    floats = (ctypes.c_float * 8)(init, obj, match, 1 - momentum, momentum, conf, bd_iou,
                                  class_iou)
    KERNEL.launch(*(ctypes.cast(x, ctypes.c_void_p) for x in (ptrs, ints, floats)))
    return outs


tracker_step_op = _lib.define_op(
    "tracker_step",
    "(" + ", ".join(f"Tensor {n}" for n in FIELDS) + ", Tensor det_bboxes, Tensor det_labels,"
    " Tensor det_embeds, Tensor det_valid, Tensor frame_ids, float[] thr,"
    " int memo_tracklet_frames, bool with_cats, str match_metric) -> Tensor[]",
    cpu=tracker_step_plain, cuda=lambda *args: _tracker_step_cuda(*args),
    fake=lambda *args: _outputs(args[:len(FIELDS)], args[len(FIELDS) + 3]))


def tracker_step_batched(cfg, state: TrackerState, bboxes: torch.Tensor, labels: torch.Tensor,
                         embeds: torch.Tensor, det_valid: torch.Tensor, frame_ids: torch.Tensor
                         ) -> Tuple[TrackerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tracker step of B clips.  cfg: a ``TrackerConfig`` (thresholds,
    momentum, metric; the capacities come from the shapes); state: every
    field with a leading clip axis (``init_batched_tracker_states``);
    bboxes (B, D, 5) f32 with the score in column 4; labels (B, D) int32;
    embeds (B, D, E) f32; det_valid (B, D) bool; frame_ids (B,) int32.

    Returns (new_state, ids, order, kept), each of the last three (B, D), as
    ``infer/tracker.py::tracker_step`` gives them per clip.  The input state
    is left as it was.  A CUDA tensor launches the kernel once for all clips;
    a CPU tensor takes the plain version."""
    out = tracker_step_op(*(getattr(state, n) for n in FIELDS), bboxes, labels, embeds,
                          det_valid, frame_ids, [float(getattr(cfg, n)) for n in THRESHOLDS],
                          int(cfg.memo_tracklet_frames), bool(cfg.with_cats), cfg.match_metric)
    return TrackerState(*out[:len(FIELDS)]), *out[len(FIELDS):]
