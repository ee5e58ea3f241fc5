"""Image-mode evaluation runner; the single-process part of
``polyphonicformer_tpu/evalutils/runner.py`` over the port's
``make_image_step``.

The sharded evaluation (``allgather_frame_stats``, ``sharded=True``) waits
for the port's distributed slice, and ``make_eval_hook`` for its training
CLI.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .dvpq import DEPTH_THRS
from .vpq import aggregate_pq, apply_depth_threshold, compute_depth_errors, vpq_eval

_DEPTH_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def frame_stats(pred_pan: np.ndarray, gt_pan: np.ndarray,
                pred_depth: np.ndarray, gt_depth: np.ndarray,
                num_classes: int = 19
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw per-frame stats, additive across frames/hosts.

    Returns (vpq (L, 4, num_classes+1) f64 — per depth-threshold iou/tp/fn/fp,
    depth (8,) f64 — the 7 depth metrics + a trailing valid flag)."""
    vpq = np.zeros((len(DEPTH_THRS), 4, num_classes + 1), np.float64)
    for li, thr in enumerate(DEPTH_THRS):
        pp = apply_depth_threshold(pred_pan, pred_depth, gt_depth, thr,
                                   num_classes)
        vpq[li] = np.stack(vpq_eval(pp, gt_pan, num_classes=num_classes))
    derr = compute_depth_errors(pred_depth, gt_depth)
    depth = np.asarray([derr[k] for k in _DEPTH_KEYS] + [1.0], np.float64)
    return vpq, depth


def metrics_from_stats(vpq_stats: np.ndarray, depth_stats: np.ndarray,
                       num_classes: int = 19, num_things: int = 8
                       ) -> Dict[str, float]:
    """(N, L, 4, C+1) + (N, 8) stat arrays -> the evaluate_image metric dict
    (reference: datasets/cityscapes_dvps.py:350-443)."""
    out: Dict[str, float] = {}
    w = depth_stats[:, -1]
    denom = max(w.sum(), 1.0)
    for i, k in enumerate(_DEPTH_KEYS):
        out[f"depth_{k}"] = float((depth_stats[:, i] * w).sum() / denom)
    for li, thr in enumerate(DEPTH_THRS):
        per_frame = [tuple(vpq_stats[n, li]) for n in range(vpq_stats.shape[0])]
        agg = aggregate_pq(per_frame, num_classes, num_things)
        key = "inf" if thr == 0 else str(thr)
        out[f"pq@{key}"] = agg["pq"]
        out[f"pq_thing@{key}"] = agg["pq_thing"]
        out[f"pq_stuff@{key}"] = agg["pq_stuff"]
    out["PQ_all"] = out["pq@inf"]
    return out


def _infer_frame_stats(model_cfg, data_cfg, model, ds, infos, bf16: bool,
                       verbose: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Inference on ``model``'s device + per-frame stats over ``infos``."""
    import torch

    from ..data.cityscapes_dvps import INSTANCE_DIVISOR
    from ..data.pipeline import make_test_input
    from ..infer.pipeline import make_image_step

    dev = next(model.parameters()).device
    dt = torch.bfloat16 if bf16 else torch.float32
    vpqs: List[np.ndarray] = []
    depths: List[np.ndarray] = []
    step = None
    for info in infos:
        frame = ds.load_frame(info, segments=False)
        inp = make_test_input(frame, data_cfg)
        if step is None:
            step = make_image_step(model, model_cfg, inp["ori_hw"], compute_dtype=dt,
                                   fusion_dtype=dt)
        res = step(torch.from_numpy(inp["image"])[None].to(dev))
        sem = res.semantic.cpu().numpy().astype(np.int64)
        pan = res.panoptic.cpu().numpy().astype(np.int64)
        seg_ids = res.seg_ids.cpu().numpy()
        keep = res.keep.cpu().numpy()
        is_thing_seg = np.zeros(int(seg_ids.max()) + 2, bool)
        for sid, th in zip(seg_ids[keep], res.is_thing.cpu().numpy()[keep]):
            is_thing_seg[sid] = th
        inst = np.where(is_thing_seg[pan], pan, 0)
        pred_pan = sem * INSTANCE_DIVISOR + inst
        v, d = frame_stats(pred_pan, frame["pan"], res.depth.cpu().numpy(),
                           frame["depth"])
        vpqs.append(v)
        depths.append(d)
        if verbose:
            print(f"frame {info['seq_id']:06d}_{info['img_id']:06d} done",
                  flush=True)
    lthr, nc1 = len(DEPTH_THRS), 20
    if not vpqs:
        return (np.zeros((0, lthr, 4, nc1)), np.zeros((0, 8)))
    return np.stack(vpqs), np.stack(depths)


def evaluate_frames(model_cfg, data_cfg, model, ds, frames,
                    verbose: bool = False, bf16: bool = False) -> Dict[str, float]:
    """Run single-frame panoptic+depth inference with ``model`` (on its own
    device) over ``frames`` and compute image PQ + depth metrics
    (CityscapesDVPSDataset.evaluate equivalent)."""
    vpq_stats, depth_stats = _infer_frame_stats(
        model_cfg, data_cfg, model, ds, frames, bf16, verbose)
    return metrics_from_stats(vpq_stats, depth_stats)
