"""Resize ops with PyTorch interpolation semantics (align_corners=False),
mirroring ``polyphonicformer_tpu/ops/resize.py``.

``resize_bilinear`` at an integer factor (<= 8 per axis) is the exact phase
upsample: on a CUDA tensor it launches the K2 kernel
(``ops/cuda/upsample2.py``), on a CPU tensor its plain version.  Any other
factor uses the dense interpolation-matrix form, ``resize_bilinear_matmul``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import upsample_int
from .device_tables import device_table


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation matrix, align_corners=False."""
    i = np.arange(out_size, dtype=np.float64)
    src = (i + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src)
    lam = src - x0
    x0c = np.clip(x0, 0, in_size - 1).astype(np.int64)
    x1c = np.clip(x0 + 1, 0, in_size - 1).astype(np.int64)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, x0c), (1.0 - lam).astype(np.float32))
    np.add.at(mat, (rows, x1c), lam.astype(np.float32))
    return mat


@device_table(maxsize=64)
def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The matrix on ``device``, copied there once (a copy from host memory
    would stall the stream on every call)."""
    return torch.from_numpy(_bilinear_matrix(in_size, out_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of the last two axes (..., H, W), computed in f32 and
    returned in ``x``'s dtype."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    *lead, in_h, in_w = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    if out_h % in_h == 0 and out_w % in_w == 0 and out_h // in_h <= 8 \
            and out_w // in_w <= 8:
        y = upsample_int(x.float().reshape(-1, in_h, in_w).contiguous(),
                         out_h // in_h, out_w // in_w)
        return y.reshape(*lead, out_h, out_w).to(x.dtype)
    return resize_bilinear_matmul(x, out_hw)


def resize_bilinear_matmul(x: torch.Tensor, out_hw, precise: bool = True) -> torch.Tensor:
    """The dense interpolation-matrix form of :func:`resize_bilinear` at any
    factor, returned in ``x``'s dtype.  The semantic FPN's x2 uses it
    directly, as the JAX package's ``resize_bilinear_nhwc`` does.

    ``precise`` computes in f32 (the JAX package's HIGHEST precision).
    ``precise=False`` on a bf16 ``x`` repeats its ``precise=False`` form:
    the matrices and the row pass are rounded to bf16, each product summed
    in f32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return x
    rh, rw = _matrix(in_h, out_h, x.device), _matrix(in_w, out_w, x.device)
    low = not precise and x.dtype != torch.float32
    if low:
        rh, rw = rh.to(x.dtype).float(), rw.to(x.dtype).float()
    y = torch.einsum("oh,...hw->...ow", rh, x.float())
    if low:
        y = y.to(x.dtype).float()
    y = torch.einsum("pw,...ow->...op", rw, y)
    return y.to(x.dtype)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of the last two axes (the FPN top-down path)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
