"""Test-time preprocessing: the test half of
``polyphonicformer_tpu/data/pipeline.py`` (``normalize_image``, ``pad_to``,
``make_test_input``).  At the test scale factor 1.0 there is no resize, so
nothing here needs cv2.  The train half (resize, flip, crop, GT prep) waits
for the training CLI.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    out = np.subtract(img, np.asarray(mean, np.float32), dtype=np.float32)
    out /= np.asarray(std, np.float32)
    return out


def pad_to(img: np.ndarray, ph: int, pw: int, value=0) -> np.ndarray:
    h, w = img.shape[:2]
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, constant_values=value)


def make_test_input(frame: Dict, data_cfg) -> Dict:
    """Normalize, then pad with 0 to the size divisor (reference
    configs/_base_/datasets/cityscapes_dvps.py:23-41: Normalize before Pad,
    so the pad is 0 in normalized space)."""
    img = normalize_image(frame["img"], data_cfg.mean, data_cfg.std)
    h, w = img.shape[:2]
    div = data_cfg.size_divisor
    ph = (h + div - 1) // div * div
    pw = (w + div - 1) // div * div
    return dict(image=pad_to(img, ph, pw), ori_hw=(h, w),
                seq_id=frame["seq_id"], img_id=frame["img_id"])
