"""Hard-mask pooling, K1: ``out[b, n, c] = sum_hw [sigmoid(m) > thr] * f``.

Replaces ``polyphonicformer_tpu/ops/pallas/mask_pool.py::_masked_pool_tpu``
(reached through ``masked_pool``).  The CUDA kernel is
``csrc/mask_pool.cu``: a split-HW skinny GEMM with the threshold applied
while the mask tile is staged, f32 accumulation and a deterministic second
pass over the splits (the source note there gives the bound and design).
:func:`masked_pool` is a ``torch.autograd.Function`` with the JAX custom
VJP (``mask_pool.py::_bwd``): zero gradient to the logits (a hard
threshold) and ``hard^T @ g`` to the features, in their dtype.  In the JAX
package that product is an XLA einsum outside any Pallas kernel; here it is
``torch.matmul``.
"""
from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_mask_pool", [
    _lib.P, _lib.I32, _lib.P, _lib.I32, _lib.I64, _lib.I64, _lib.I64,
    _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.F32,
    _lib.I32, _lib.I32])

_DTYPES = (torch.float32, torch.bfloat16)
_TK = 32  # hw positions per shared-memory stage (csrc/mask_pool.cu)


def mask_pool_plain(mask_logits: torch.Tensor, feats: torch.Tensor,
                    thr: float = 0.5) -> torch.Tensor:
    """mask_logits (B, N, h, w), feats (B, h, w, C) -> (B, N, C) f32."""
    hard = (torch.sigmoid(mask_logits.float()) > thr).float()
    return torch.einsum("bnhw,bhwc->bnc", hard, feats.float())


def _splits(tiles: int, hw: int) -> tuple[int, int]:
    """Split HW so that about four blocks per SM are in flight."""
    steps = -(-hw // _TK)
    splits = max(1, min(steps, -(-4 * 132 // tiles)))
    chunk = -(-steps // splits) * _TK
    return -(-hw // chunk), chunk


def _mask_pool_cuda(mask_logits: torch.Tensor, feats: torch.Tensor,
                    thr: float) -> torch.Tensor:
    _lib.check_cuda("mask_logits", mask_logits, _DTYPES, ndim=4)
    _lib.check_cuda("feats", feats, _DTYPES, ndim=4, contiguous=False)
    b, n, h, w = mask_logits.shape
    c = feats.shape[-1]
    if feats.shape[:3] != (b, h, w) or feats.device != mask_logits.device:
        raise ValueError(f"feats {tuple(feats.shape)} on {feats.device} does not "
                         f"match mask_logits {tuple(mask_logits.shape)}")
    sb, sh, sw, sc = feats.stride()
    if sh != w * sw:
        raise ValueError("feats: the (h, w) axes must flatten without a copy")
    tiles = -(-c // 64) * -(-n // 32) * b
    splits, chunk = _splits(tiles, h * w)
    partial = torch.empty((splits, b, n, c), device=feats.device,
                          dtype=torch.float32)
    out = torch.empty((b, n, c), device=feats.device, dtype=torch.float32)
    KERNEL.launch(
        mask_logits.data_ptr(), int(mask_logits.dtype == torch.bfloat16),
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), sb, sw, sc,
        partial.data_ptr(), out.data_ptr(), b, n, h * w, c, float(thr),
        splits, chunk)
    return out


class _MaskedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask_logits: torch.Tensor, feats: torch.Tensor,
                thr: float) -> torch.Tensor:
        ctx.save_for_backward(mask_logits)
        ctx.thr, ctx.feats_dtype = thr, feats.dtype
        if mask_logits.is_cuda:
            return _mask_pool_cuda(mask_logits, feats, thr)
        if mask_logits.device.type == "cpu":
            return mask_pool_plain(mask_logits, feats, thr)
        raise ValueError(f"masked_pool: unsupported device {mask_logits.device}")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (mask_logits,) = ctx.saved_tensors
        b, n, h, w = mask_logits.shape
        hard = (torch.sigmoid(mask_logits.float()) > ctx.thr).float().reshape(b, n, h * w)
        dfeat = torch.matmul(hard.transpose(1, 2), g.float())  # (B, hw, C)
        return None, dfeat.reshape(b, h, w, -1).to(ctx.feats_dtype), None


def masked_pool(mask_logits: torch.Tensor, feats: torch.Tensor,
                thr: float = 0.5) -> torch.Tensor:
    """Batched hard-mask pooling in f32.

    mask_logits: (B, N, h, w); feats: (B, h, w, C), any strides whose (h, w)
    axes flatten (a permuted NCHW tensor is taken as it is).  Returns
    (B, N, C) float32, differentiable in ``feats``.  A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version.
    """
    return _MaskedPool.apply(mask_logits, feats, thr)
