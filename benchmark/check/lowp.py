"""The control's lower precision: float8 (e4m3) for a bf16 configuration.

:func:`fake_quant_` rounds the weights (a parametrization, so every use of a
weight reads it rounded) and the inputs (a forward pre-hook) of every
convolution and linear layer of a model to float8 e4m3, one scale a tensor,
so every product of those layers sees float8 operands and accumulates as
before: the arithmetic of an fp8 GEMM.  Gradients pass the rounding straight
through.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class _RoundFp8(torch.autograd.Function):
    """Rounds in the forward, passes the gradient straight through."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Weight(nn.Module):
    def forward(self, w):
        return _RoundFp8.apply(w)


def _pre_hook(_module, args):
    return (_RoundFp8.apply(args[0]),) + tuple(args[1:])


def fake_quant_(model: nn.Module) -> nn.Module:
    """Round ``model``'s convolution and linear weights and inputs to
    float8 at every use; returns the model."""
    for m in list(model.modules()):
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            parametrize.register_parametrization(m, "weight", _Fp8Weight())
            m.register_forward_pre_hook(_pre_hook)
    return model
