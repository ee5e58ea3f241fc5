"""Floating-point operations of one step of a configuration, counted once on
the benchmark's plain reference (``benchmark/reference``) under
``torch.utils.flop_counter.FlopCounterMode`` on meta tensors: convolutions,
matrix products and attention's two products, at the cell's shapes.

* serving: the network's forward over the batch (backbone, FPN, kernel head,
  update stages) and the track head over ``max_detections`` boxes an image;
* training: the key frames' forward and backward, the ref frames' backbone
  and FPN forward (no gradient), and the track head's forward and backward
  over the GT slots of both frames.  The backbone's recompute under
  ``torch.utils.checkpoint`` is not counted.

Nothing is counted from the program's own dispatched operations, so the
count stays the same whatever implements the work.
"""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import config as ref_config
from ..reference.models.polyphonic import PolyphonicFormer


def _model(exp, train: bool) -> PolyphonicFormer:
    with torch.device("meta"):
        model = PolyphonicFormer(exp.model)
    model.remat_backbone = False
    if not train:
        model.requires_grad_(False)
    return model.train(train)


def _sum(outputs) -> torch.Tensor:
    total = 0
    for x in outputs:
        if torch.is_tensor(x) and x.requires_grad:
            total = total + x.float().sum()
        elif isinstance(x, tuple):
            total = total + _sum(x)
    return total


def serve_flops(exp, batch: int, hw) -> float:
    model = _model(exp, False)
    det = exp.model.tracker.max_detections
    img = torch.empty((batch, *hw, 3), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fpn = model.extract_feat(img)
        model.forward_heads(fpn, with_aspp=False)
        model.forward_track_embeds(fpn, None, torch.ones((batch, det), dtype=torch.bool,
                                                         device="meta"),
                                   boxes=torch.empty((batch, det, 4), device="meta"))
    return float(counter.get_total_flops())


def train_flops(exp, batch: int, hw) -> float:
    model = _model(exp, True)
    slots = exp.model.max_things
    img = torch.empty((batch, *hw, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        key = model.extract_feat(img)
        out = model.forward_heads(key)
        with torch.no_grad():
            ref = model.extract_feat(torch.empty_like(img))
        pair = [torch.cat([k, r]) for k, r in zip(key, ref)]
        embeds = model.forward_track_embeds(
            pair, None, torch.ones((2 * batch, slots), dtype=torch.bool, device="meta"),
            boxes=torch.empty((2 * batch, slots, 4), device="meta"))
        (_sum(out.rpn) + _sum(tuple(s for st in out.stages for s in st))
         + embeds.float().sum()).backward()
    return float(counter.get_total_flops())


def forward_flops(exp, batch: int, hw) -> float:
    """The network's forward alone (backbone, FPN, heads), for comparison
    with other counts."""
    model = _model(exp, False)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward_heads(model.extract_feat(torch.empty((batch, *hw, 3), device="meta")),
                            with_aspp=False)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def step_flops(config_path: str, kind: str, batch: int) -> float:
    """FLOPs of one ``kind`` step ("serve" or "train") of the configuration
    file at ``config_path``, at its ``image_hw`` and ``batch``."""
    with open(config_path) as f:
        cfg = json.load(f)
    exp = ref_config.experiment(cfg)
    hw = tuple(cfg["image_hw"])
    return (serve_flops if kind == "serve" else train_flops)(exp, batch, hw)
