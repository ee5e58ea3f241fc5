"""Static-shape batch structures; mirrors
``polyphonicformer_tpu/data/structures.py``.

Ground truth is padded to fixed capacities: thing instances to
``max_things`` slots with a validity mask, stuff keyed by class (slot ``s``
holds the mask of stuff class ``num_things + s``), everything at the
assignment resolution (stride 4).  Batched structures carry a leading B
axis on every field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GTSample(NamedTuple):
    thing_masks: torch.Tensor  # (M, h, w) f32 soft masks at stride 4
    thing_labels: torch.Tensor  # (M,) int32 in [0, num_things), pad = -1
    thing_valid: torch.Tensor  # (M,) bool
    thing_inst_ids: torch.Tensor  # (M,) int32 global instance ids, pad = -1
    stuff_masks: torch.Tensor  # (S, h, w) f32, slot s = class T + s
    stuff_valid: torch.Tensor  # (S,) bool
    depth: torch.Tensor  # (h, w) f32 metric depth at stride 4, 0 = invalid
    valid_mask: torch.Tensor  # (h, w) f32 union of all GT masks


class TrainBatch(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) normalized f32, or raw uint8
    gt: GTSample  # batched
    ref_image: Optional[torch.Tensor] = None  # (B, H, W, 3), video training
    ref_gt: Optional[GTSample] = None
