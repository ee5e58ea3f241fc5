"""Semantic map -> instance masks with thing-first labels, for DVPS datasets
whose semantic ids are not thing-first (COCO, Cityscapes and KITTI-STEP /
SemKITTI-DVPS layouts); a copy of ``polyphonicformer_tpu/data/label_shift.py``
(reference polyphonic/utils.py:4-89, ``sem2ins_masks*``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def sem2ins_masks(sem_seg: np.ndarray, inst_seg: np.ndarray, num_thing_classes: int,
                  thing_ids: Sequence[int], ignore_id: int = 255
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a (semantic, instance) pair into per-segment binary masks with
    thing-first labels.

    sem_seg: (H, W) original semantic ids; inst_seg: (H, W) instance ids (0
    for stuff); thing_ids: the original ids of the thing classes, in the
    order they map to [0, num_thing_classes); ignore_id is dropped; the stuff
    ids follow in ascending order.  Returns (masks (N, H, W) uint8, labels
    (N,), panoptic ids sem * 100000 + inst (N,))."""
    thing_map = {int(t): i for i, t in enumerate(thing_ids)}
    stuff_ids = sorted(set(np.unique(sem_seg).tolist()) - set(thing_map) - {ignore_id})
    stuff_map = {int(s): num_thing_classes + i for i, s in enumerate(stuff_ids)}

    masks, labels, inst_ids = [], [], []
    pan = sem_seg.astype(np.int64) * 100000 + inst_seg.astype(np.int64)
    for pid in np.unique(pan):
        sem = int(pid) // 100000
        if sem == ignore_id:
            continue
        masks.append((pan == pid).astype(np.uint8))
        labels.append(thing_map[sem] if sem in thing_map else stuff_map[sem])
        inst_ids.append(int(pid))
    if not masks:
        return (np.zeros((0,) + sem_seg.shape, np.uint8), np.zeros((0,), np.int64),
                np.zeros((0,), np.int64))
    return np.stack(masks), np.asarray(labels), np.asarray(inst_ids)


# KITTI-STEP / SemKITTI-DVPS: the 19 Cityscapes trainIds, things person=11,
# rider=12, car=13, truck=14, bus=15, train=16, motorcycle=17, bicycle=18
CITYSCAPES_THING_TRAINIDS = (11, 12, 13, 14, 15, 16, 17, 18)


def sem2ins_masks_cityscapes(sem_seg: np.ndarray, inst_seg: np.ndarray):
    return sem2ins_masks(sem_seg, inst_seg, 8, CITYSCAPES_THING_TRAINIDS)
