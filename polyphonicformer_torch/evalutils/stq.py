"""STQ (Segmentation and Tracking Quality) for video panoptic sequences; a
copy of ``polyphonicformer_tpu/evalutils/stq.py``.

reference: datasets/utils.py:140-168 ships the per-frame
component extractor (``stq``) but never aggregates it (no tool calls it).
This module ports that extractor bit-for-bit (oracle-tested against the
reference function) and adds the standard STEP aggregation
(STQ = sqrt(AQ * SQ), van den Brand et al. / DeepLab2 STQuality):

  SQ = mean per-class IoU over the semantic confusion built from
       ``semantic_ids`` (label * label_divisor + prediction);
  AQ = mean over GT tracks of (1/|gt_t|) * sum_p |p n t| * IoU(p, t)
       over prediction tracks p with nonzero overlap.

Inputs are full-sequence panoptic id maps (class * max_ins + instance) with
instance ids consistent ACROSS frames of one sequence.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def stq_element(y_pred: np.ndarray, y_true: np.ndarray, num_classes: int = 19,
                max_ins: int = 10000, ign_id: int = 255, num_things: int = 8,
                label_divisor: int = 10**4, ins_divisor: int = 10**7):
    """Per-frame STQ components (reference datasets/utils.py:140-168)."""
    y_true = y_true.astype(np.int64)
    y_pred = y_pred.astype(np.int64)

    semantic_label = y_true // max_ins
    semantic_prediction = y_pred // max_ins
    semantic_label = np.where(semantic_label != ign_id, semantic_label,
                              num_classes)
    semantic_prediction = np.where(semantic_prediction != ign_id,
                                   semantic_prediction, num_classes)
    semantic_ids = (np.reshape(semantic_label, [-1]) * label_divisor
                    + np.reshape(semantic_prediction, [-1]))

    instance_label = y_true % max_ins
    label_mask = np.less(semantic_label, num_things)
    prediction_mask = np.less(semantic_label, num_things)
    is_crowd = np.logical_and(instance_label == 0, label_mask)

    label_mask = np.logical_and(label_mask, np.logical_not(is_crowd))
    prediction_mask = np.logical_and(prediction_mask, np.logical_not(is_crowd))

    seq_preds = y_pred[prediction_mask]
    seg_labels = y_true[label_mask]

    non_crowd_intersection = np.logical_and(label_mask, prediction_mask)
    intersection_ids = (y_true[non_crowd_intersection] * ins_divisor
                        + y_pred[non_crowd_intersection])
    return semantic_ids, seq_preds, seg_labels, intersection_ids


class STQAccumulator:
    """Aggregates stq_element outputs over the frames of many sequences.

    Every store is keyed by (seq_id, id): instance ids are only consistent
    WITHIN a sequence, so the same numeric id in two sequences must count as
    two distinct tracks (DeepLab2 STQuality prefixes ids with the sequence
    for the same reason). The semantic confusion sums over sequences."""

    def __init__(self, num_classes: int = 19, num_things: int = 8,
                 label_divisor: int = 10**4, ins_divisor: int = 10**7):
        self.num_classes = num_classes
        self.num_things = num_things
        self.label_divisor = label_divisor
        self.ins_divisor = ins_divisor
        self._sem: Dict[tuple, int] = {}
        self._pred: Dict[tuple, int] = {}
        self._gt: Dict[tuple, int] = {}
        self._inter: Dict[tuple, int] = {}

    def update(self, y_pred: np.ndarray, y_true: np.ndarray,
               seq_id: int = 0) -> None:
        sem_ids, seq_preds, seg_labels, inter_ids = stq_element(
            y_pred, y_true, num_classes=self.num_classes,
            num_things=self.num_things, label_divisor=self.label_divisor,
            ins_divisor=self.ins_divisor)
        for store, ids in ((self._sem, sem_ids), (self._pred, seq_preds),
                           (self._gt, seg_labels), (self._inter, inter_ids)):
            vals, counts = np.unique(ids, return_counts=True)
            for v, c in zip(vals.tolist(), counts.tolist()):
                key = (seq_id, v)
                store[key] = store.get(key, 0) + int(c)

    def result(self) -> Dict[str, float]:
        nc = self.num_classes
        # SQ: per-class IoU from the (label, prediction) confusion
        conf = np.zeros((nc + 1, nc + 1), np.int64)
        for (_, key), cnt in self._sem.items():
            lab, pred = divmod(key, self.label_divisor)
            if lab <= nc and pred <= nc:
                conf[lab, pred] += cnt
        ious = []
        for c in range(nc):  # the ignore row/col (nc) is excluded
            tp = conf[c, c]
            denom = conf[c, :].sum() + conf[:, c].sum() - tp
            if conf[c, :].sum() > 0:
                ious.append(tp / max(denom, 1))
        sq = float(np.mean(ious)) if ious else 0.0

        # AQ over GT tracks (tracks are (seq, id)-scoped)
        aq_sum, n_tracks = 0.0, 0
        inter_by_gt: Dict[tuple, List[Tuple[tuple, int]]] = {}
        for (seq, key), cnt in self._inter.items():
            gt_id, pred_id = divmod(key, self.ins_divisor)
            inter_by_gt.setdefault((seq, gt_id), []).append(
                ((seq, pred_id), cnt))
        for gt_key, gt_size in self._gt.items():
            track_aq = 0.0
            for pred_key, inter in inter_by_gt.get(gt_key, []):
                pred_size = self._pred.get(pred_key, 0)
                union = gt_size + pred_size - inter
                track_aq += inter * (inter / max(union, 1))
            aq_sum += track_aq / max(gt_size, 1)
            n_tracks += 1
        aq = aq_sum / max(n_tracks, 1)
        return {"STQ": float(np.sqrt(aq * sq)), "AQ": float(aq), "SQ": sq}

