"""Seeded weights, made on the card in one draw and handed to both sides as
one state dict under the mmdet keys.

Keys and shapes come from the reference model on the meta device.  The rule
is the port's ``init_weights``: lecun-normal weights (std 1/sqrt(fan-in)),
unit norm scales, zero biases and BN statistics of an identity, the query
kernels at std 1, the backbone file's ``INIT_STD`` (key suffix -> std; Swin's
relative-position bias tables at 0.02) for its backbone and neck keys, and
the classification biases at prior 0.01; every normal value comes from one
``torch.randn`` of the model's size, in key order.
"""
from __future__ import annotations

import math

import torch

from .reference.models.polyphonic import PolyphonicFormer, backbone_file

_PRIOR = -math.log((1 - 0.01) / 0.01)


def _std(name: str, shape, init_std: dict) -> float:
    if name.startswith(("backbone.", "neck.")):
        for suffix, std in init_std.items():
            if name.endswith(suffix):
                return std
    if "init_kernels" in name:
        return 1.0
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return 1.0 / math.sqrt(fan_in)


def state_dict(exp, seed: int, device, zero_class_bias: bool = False) -> dict:
    """The f32 state dict of ``exp.model`` drawn from ``seed`` on
    ``device``.  ``zero_class_bias``: the last update stage's ``fc_cls``
    bias 0, so that thing scores straddle ``instance_score_thr`` and served
    frames hold segments and detections."""
    with torch.device("meta"):
        meta = PolyphonicFormer(exp.model).state_dict()
    drawn = [(k, v.shape) for k, v in meta.items()
             if v.dim() > 1 and not k.endswith(("running_mean", "running_var"))]
    init_std = getattr(backbone_file(exp.model.backbone), "INIT_STD", {})
    total = sum(math.prod(shape) for _, shape in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((total,), generator=gen, device=device)
    out, i = {}, 0
    for k, shape in drawn:
        n = math.prod(shape)
        out[k] = flat[i:i + n].view(shape).mul_(_std(k, shape, init_std))
        i += n
    last = f"roi_head.mask_head.{exp.model.num_stages - 1}.fc_cls.bias"
    for k, v in meta.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "running_var" or (v.dim() == 1 and not leaf.endswith("bias")
                                     and leaf != "running_mean"):
            fill = 1.0
        elif leaf.endswith("bias") and k.endswith(("fc_cls.bias", "conv_seg.bias")):
            fill = 0.0 if (zero_class_bias and k == last) else _PRIOR
        else:
            fill = 0.0
        out[k] = torch.full(v.shape, fill, dtype=v.dtype, device=device)
    return {k: out[k] for k in meta}
