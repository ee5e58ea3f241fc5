"""(Video) Panoptic Quality and depth error metrics; a copy of
``polyphonicformer_tpu/evalutils/vpq.py``.

``vpq_eval`` runs the port's native core (``ops/native.py::vpq_stats``, a
copy of the JAX package's ``native/vpq_core.cpp``) and raises if it does not
build; ``vpq_eval_plain`` is the Python version, which only the tests call.

reference: datasets/utils.py:31-137.  Same math
(category = id // INSTANCE_DIVISOR, IoU>0.5 TP matching with void handling),
implemented with vectorized numpy unique/searchsorted instead of Python
dicts over six.iteritems — ~10x faster per frame, which matters because DVPQ
evaluates 16 (window, lambda) combinations over every clip.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops import native

INSTANCE_DIVISOR = 10000


def vpq_eval(pred_ids: np.ndarray, gt_ids: np.ndarray, num_classes: int = 19,
             max_ins: int = INSTANCE_DIVISOR, ign_id: int = 255
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Single (possibly frame-concatenated) panoptic comparison.

    Returns per-category (iou, tp, fn, fp), each of length num_classes + 1.
    """
    return native.vpq_stats(pred_ids.reshape(-1).astype(np.int64),
                            gt_ids.reshape(-1).astype(np.int64), num_classes, max_ins, ign_id)


def vpq_eval_plain(pred_ids: np.ndarray, gt_ids: np.ndarray, num_classes: int = 19,
                   max_ins: int = INSTANCE_DIVISOR, ign_id: int = 255
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of :func:`vpq_eval` (the JAX package's Python path):
    the same counts; the IoU sums may differ in the last bits, since the
    native core adds a class's matches in hash order, this one in id order."""
    pred_ids = pred_ids.reshape(-1).astype(np.int64)
    gt_ids = gt_ids.reshape(-1).astype(np.int64)

    offset = int(1e9)
    num_cat = num_classes + 1

    iou_per_class = np.zeros(num_cat, np.float64)
    tp_per_class = np.zeros(num_cat, np.float64)
    fn_per_class = np.zeros(num_cat, np.float64)
    fp_per_class = np.zeros(num_cat, np.float64)

    pred_u, pred_c = np.unique(pred_ids, return_counts=True)
    gt_u, gt_c = np.unique(gt_ids, return_counts=True)
    int_u, int_c = np.unique(gt_ids * offset + pred_ids, return_counts=True)

    int_gt = int_u // offset
    int_pred = int_u % offset
    int_gt_cat = int_gt // max_ins
    int_pred_cat = int_pred // max_ins

    pred_area = dict(zip(pred_u.tolist(), pred_c.tolist()))
    gt_area = dict(zip(gt_u.tolist(), gt_c.tolist()))

    # overlap of each pred segment with void (ign class) gt
    void_gt_mask = int_gt_cat == ign_id
    void_overlap: Dict[int, int] = {}
    for p, a in zip(int_pred[void_gt_mask].tolist(), int_c[void_gt_mask].tolist()):
        void_overlap[p] = void_overlap.get(p, 0) + a
    # exact void id (ign_id * max_ins) overlap, used in the union denominator
    void_exact_mask = int_gt == ign_id * max_ins
    void_exact: Dict[int, int] = dict(
        zip(int_pred[void_exact_mask].tolist(), int_c[void_exact_mask].tolist()))

    gt_matched = set()
    pred_matched = set()
    same_cat = (int_gt_cat == int_pred_cat) & (int_gt_cat != ign_id)
    for g, p, a, cat in zip(int_gt[same_cat].tolist(), int_pred[same_cat].tolist(),
                            int_c[same_cat].tolist(), int_gt_cat[same_cat].tolist()):
        union = gt_area[g] + pred_area[p] - a - void_exact.get(p, 0)
        iou = a / union
        if iou > 0.5:
            tp_per_class[cat] += 1
            iou_per_class[cat] += iou
            gt_matched.add(g)
            pred_matched.add(p)

    for g, cat in zip(gt_u.tolist(), (gt_u // max_ins).tolist()):
        if g in gt_matched or cat == ign_id:
            continue
        fn_per_class[cat] += 1

    for p, cat in zip(pred_u.tolist(), (pred_u // max_ins).tolist()):
        if p in pred_matched:
            continue
        if void_overlap.get(p, 0) / pred_area[p] > 0.5:
            continue
        fp_per_class[cat] += 1

    return iou_per_class, tp_per_class, fn_per_class, fp_per_class


def compute_depth_errors(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Standard monodepth error metrics (datasets/utils.py:109-137)."""
    valid = gt > 0.0
    pred = pred[valid]
    gt = gt[valid]
    thresh = np.maximum(gt / pred, pred / gt)
    return {
        "abs_rel": float(np.mean(np.abs(gt - pred) / gt)),
        "sq_rel": float(np.mean(((gt - pred) ** 2) / gt)),
        "rmse": float(np.sqrt(np.mean((gt - pred) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))),
        "a1": float((thresh < 1.25).mean()),
        "a2": float((thresh < 1.25 ** 2).mean()),
        "a3": float((thresh < 1.25 ** 3).mean()),
    }


def apply_depth_threshold(pred_pan: np.ndarray, pred_depth: np.ndarray,
                          gt_depth: np.ndarray, depth_thr: float,
                          num_classes: int = 19,
                          max_ins: int = INSTANCE_DIVISOR) -> np.ndarray:
    """Void out predictions whose relative depth error exceeds depth_thr
    (reference: polyphonic/apis/video_evaluate.py:29-35)."""
    if depth_thr <= 0:
        return pred_pan
    out = pred_pan.copy()
    valid = gt_depth > 0.0
    bad = np.zeros_like(valid)
    bad[valid] = (np.abs(pred_depth[valid] - gt_depth[valid]) / gt_depth[valid]
                  ) > depth_thr
    out[bad] = num_classes * max_ins
    return out


def aggregate_pq(results, num_classes: int = 19, num_things: int = 8,
                 eps: float = 1e-15) -> Dict[str, object]:
    """Aggregate per-frame/clip vpq tuples into PQ/SQ/RQ summaries
    (video_evaluate.py:94-111)."""
    iou = np.stack([r[0] for r in results]).sum(axis=0)[:num_classes]
    tp = np.stack([r[1] for r in results]).sum(axis=0)[:num_classes]
    fn = np.stack([r[2] for r in results]).sum(axis=0)[:num_classes]
    fp = np.stack([r[3] for r in results]).sum(axis=0)[:num_classes]
    sq = iou / (tp + eps)
    rq = tp / (tp + 0.5 * fn + 0.5 * fp + eps)
    pq = np.nan_to_num(sq * rq)
    return {
        "pq_per_class": pq,
        "pq": float(pq.mean()),
        "pq_thing": float(pq[:num_things].mean()),
        "pq_stuff": float(pq[num_things:].mean()),
        "sq": np.nan_to_num(sq),
        "rq": np.nan_to_num(rq),
    }
