"""Megatron-style tensor parallelism over the mesh's model axis; the port's
counterpart of the JAX package's logical-axis sharding of Swin
(``polyphonicformer_tpu/models/swin.py:33-45``, ``SWIN_LOGICAL_RULES``).

A column-parallel linear holds rows of the full weight (its outputs) and
takes its input through Megatron's ``f``: identity forward, gradient
summed over the model group.  A row-parallel linear holds columns of the
full weight (its inputs), sums its partial products over the model group
through ``g`` (all-reduce forward, identity backward), in f32 for a bf16
model, and adds its bias once, after the sum.

:func:`param_layout` names each parameter of a model ``sharded`` (a rank
holds its own part), ``partial`` (replicated, but a rank's gradient covers
only its own part: Swin's bias tables, which each rank gathers for its
heads only) or ``replicated``; the train step reduces their gradients
accordingly (``train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .mesh import copy_to, sum_over


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """What a tensor-parallel module needs of the mesh: the model group,
    this rank's index in it and its size."""
    group: Optional[object]
    index: int
    size: int

    def __deepcopy__(self, memo):  # a copy of a model shares its process group
        return self


def model_parallel(mesh) -> Optional[ModelParallel]:
    """The mesh's model axis, or None when it has one rank."""
    if mesh is None or mesh.num_model == 1:
        return None
    return ModelParallel(mesh.model_group, mesh.model_index, mesh.num_model)


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(start, count) of part ``index`` when ``n`` splits into ``parts``
    contiguous parts, the first ``n % parts`` one longer: 3 heads over 2
    ranks are 2 + 1."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return start, base + (index < extra)


class ColumnParallelLinear(nn.Linear):
    """The rows ``out_features`` of a full linear's weight and bias this
    rank holds; the input's gradient summed over the model group."""
    tp_layout = {"weight": "sharded", "bias": "sharded"}

    def __init__(self, in_features: int, out_features: int, tp: ModelParallel, bias=True):
        super().__init__(in_features, out_features, bias=bias)
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to(x, self.tp.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """The columns ``in_features`` of a full linear's weight this rank
    holds; partial products summed over the model group in f32, then the
    (replicated) bias, then the input's dtype."""
    tp_layout = {"weight": "sharded", "bias": "replicated"}

    def __init__(self, in_features: int, out_features: int, tp: ModelParallel, bias=True):
        super().__init__(in_features, out_features, bias=bias)
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = sum_over(F.linear(x, self.weight).float(), self.tp.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def param_layout(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> ``sharded``, ``partial`` or ``replicated``, from
    each module's ``tp_layout`` (a module without one: replicated)."""
    out = {}
    for mod_name, mod in model.named_modules():
        layout = getattr(mod, "tp_layout", None) or {}
        for p_name, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            out[key] = layout.get(p_name, "replicated")
    return out
