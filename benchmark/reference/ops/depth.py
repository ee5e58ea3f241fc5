"""Depth activation (``polyphonicformer_tpu/ops/depth.py``)."""
from __future__ import annotations

import torch


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)) with every op rounded in x's
    dtype.  In bf16 this differs from ``torch.sigmoid``, which rounds once,
    in about a third of the values (by one ulp)."""
    return 1.0 / (1.0 + torch.exp(-x))


def depth_act(depth_out: torch.Tensor, mode: str = "sigmoid",
              min_depth: float = 0.01, max_depth: float = 80.0) -> torch.Tensor:
    def const(v: float) -> float:
        # a Python scalar is weakly typed in JAX: it is rounded to x's dtype
        return torch.tensor(v, dtype=depth_out.dtype).item()

    if mode == "monodepth":
        disp = sigmoid(depth_out)
        min_disp = 1.0 / max_depth
        max_disp = 1.0 / min_depth
        return 1.0 / (const(min_disp) + const(max_disp - min_disp) * disp)
    if mode == "sigmoid":
        return sigmoid(depth_out) * const(max_depth - min_depth) + const(min_depth)
    raise NotImplementedError(mode)
