"""Hard-mask pooling, K1: ``out[b, n, c] = sum_hw [sigmoid(m) > thr] * f``.

Replaces ``polyphonicformer_tpu/ops/pallas/mask_pool.py::_masked_pool_tpu``
(reached through ``masked_pool``).  The CUDA kernel is
``csrc/mask_pool.cu``: a split-HW skinny product on the tensor cores
(``wgmma`` bf16, f32 accumulation; f32 features as three exact bf16 parts),
the threshold applied once while the mask tile is staged, and a
deterministic second pass over the HW splits, launched by the same call (the
source note there gives the bound and design).  :func:`launch_plan` is the
grid it is launched with, kept in Python so that the CPU tests check it.
:func:`masked_pool` is a ``torch.autograd.Function`` with the JAX custom
VJP (``mask_pool.py::_bwd``): zero gradient to the logits (a hard
threshold) and ``hard^T @ g`` to the features, in their dtype.  In the JAX
package that product is an XLA einsum outside any Pallas kernel; here it is
``torch.matmul``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import _lib

KERNEL = _lib.Kernel("poly_mask_pool", [
    _lib.P, _lib.I32, _lib.P, _lib.I32, _lib.I64, _lib.I64, _lib.I64,
    _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.F32,
    _lib.F32, _lib.F32, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.I32])

_DTYPES = (torch.float32, torch.bfloat16)
ROWS, CHANNELS, DEPTH = 128, 128, 64  # block tile and chunk unit (csrc/mask_pool.cu)
GRID_YZ_MAX = 65535


def mask_pool_plain(mask_logits: torch.Tensor, feats: torch.Tensor,
                    thr: float = 0.5) -> torch.Tensor:
    """mask_logits (B, N, h, w), feats (B, h, w, C) -> (B, N, C) f32."""
    hard = (torch.sigmoid(mask_logits.float()) > thr).float()
    return torch.einsum("bnhw,bhwc->bnc", hard, feats.float())


@dataclasses.dataclass(frozen=True)
class Plan:
    """Grid of one launch: (channel slices, splits, b * row tiles) blocks;
    split s covers HW positions [s * chunk, min(hw, (s + 1) * chunk))."""
    slices: int
    row_tiles: int
    splits: int
    chunk: int
    batch: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.slices, self.splits, self.batch * self.row_tiles


def launch_plan(b: int, n: int, hw: int, c: int, sm_count: int) -> Plan:
    """Split HW so that the grid holds about one block per SM (at most one
    fits an SM), in chunks of whole stages."""
    if min(b, n, hw, c, sm_count) < 1:
        raise ValueError(f"masked_pool: empty launch b={b} n={n} hw={hw} c={c}")
    slices, row_tiles = -(-c // CHANNELS), -(-n // ROWS)
    tiles = slices * row_tiles * b
    if b * row_tiles > GRID_YZ_MAX:
        raise ValueError(f"masked_pool: {b} x {row_tiles} row tiles exceed the grid")
    steps = -(-hw // DEPTH)
    chunk = -(-steps // max(1, min(steps, sm_count // tiles)))  # in stages
    return Plan(slices, row_tiles, -(-steps // chunk), chunk * DEPTH, b)


BAND_GAP = 1e-5  # least distance of the true sigmoid from thr outside the band


@functools.lru_cache(maxsize=None)
def threshold_band(thr: float) -> tuple[float, float]:
    """(lo, hi), both bf16 values, such that the true sigmoid lies at or
    below thr - 1e-5 for x <= lo and at or above thr + 1e-5 for x >= hi.
    The kernel's f32 ``1 / (1 + expf(-x))`` is within 1e-6 of the true value
    (a few f32 roundings of a number in [0, 1]), so outside (lo, hi) its
    compare with thr is known; inside, the kernel evaluates it.  bf16 ends
    let the kernel compare bf16 logits without converting them.  A thr
    within 1e-5 of 0 or 1 gets no band."""
    if not BAND_GAP < thr < 1.0 - BAND_GAP:
        return -math.inf, math.inf
    lo = math.log((thr - BAND_GAP) / (1.0 - thr + BAND_GAP))
    hi = math.log((thr + BAND_GAP) / (1.0 - thr - BAND_GAP))
    return _bf16_outwards(lo, -1), _bf16_outwards(hi, 1)


def _bf16_outwards(x: float, side: int) -> float:
    """The nearest bf16 value at or below (side -1) or above (side 1) x."""
    bits = int(np.float32(x).view(np.uint32)) & 0xFFFF0000  # toward zero
    for _ in range(3):
        y = float(np.uint32(bits).view(np.float32))
        if (y <= x) if side < 0 else (y >= x):
            return y
        bits += 0x10000 if (y < x) == (y >= 0) else -0x10000
    raise AssertionError(f"no bf16 bound for {x}")


_sm_counts: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def _aligned(t: torch.Tensor, *strides: int) -> bool:
    """16-byte aligned base and strides (in elements) of ``t``."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in strides)


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
    hw = h * w
    plan = launch_plan(b, n, hw, c, _sm_count(feats.device))
    vec_m = hw % 8 == 0 and _aligned(mask_logits)
    vec_f = sw == 1 and hw % 8 == 0 and _aligned(feats, sb, sc)
    partial = (torch.empty((plan.splits, b, n, c), device=feats.device, dtype=torch.float32)
               if plan.splits > 1 else None)
    out = torch.empty((b, n, c), device=feats.device, dtype=torch.float32)
    KERNEL.launch(
        mask_logits.data_ptr(), int(mask_logits.dtype == torch.bfloat16),
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), sb, sw, sc,
        0 if partial is None else partial.data_ptr(), out.data_ptr(),
        b, n, hw, c, float(thr),
        *threshold_band(float(thr)), plan.splits, plan.chunk, plan.row_tiles, int(vec_m),
        int(vec_f))
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
