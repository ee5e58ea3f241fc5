"""Exact integer-factor bilinear upsample, K2 (forward).

Replaces ``polyphonicformer_tpu/ops/pallas/upsample2.py::_call_fwd``
(``upsample_int_pallas`` / ``upsample2_pallas``): align_corners=False with
edge replication, in f32, rows first and then columns with the phase
weights of ``ops/resize.py::_phase_weights``.  The CUDA kernel is
``csrc/upsample.cu`` (one thread per output element; the source note there
gives the bound and design).  The transposed-stencil backward is training
work and waits.
"""
from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_upsample_int", [
    _lib.P, _lib.P, _lib.I64, _lib.I32, _lib.I32, _lib.I32, _lib.I32])


def phase_weights(factor: int) -> list[tuple[int, float, float]]:
    """Per phase: (base offset, w0, w1), as ``_phase_weights`` computes them
    (float64 lerp weight rounded to f32 last)."""
    import numpy as np

    out = []
    for p in range(factor):
        src = (p + 0.5) / factor - 0.5
        base = int(np.floor(src))
        lam = src - base
        out.append((base, float(np.float32(1.0 - lam)), float(np.float32(lam))))
    return out


def upsample_axis_plain(x: torch.Tensor, factor: int, dim: int) -> torch.Tensor:
    """Phase upsample of one axis: each output phase is a 2-tap lerp of the
    edge-replicated neighbours, multiplies and add as separate f32 ops."""
    x = x.movedim(dim, -1)
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    phases = []
    for base, w0, w1 in phase_weights(factor):
        if base == -1:  # taps (i-1, i)
            phases.append(w0 * left + w1 * x)
        else:  # taps (i, i+1)
            phases.append(w0 * x + w1 * right)
    out = torch.stack(phases, dim=-1).reshape(*x.shape[:-1], x.shape[-1] * factor)
    return out.movedim(-1, dim)


def upsample_int_plain(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """x (N, h, w) f32 -> (N, fy*h, fx*w) f32."""
    return upsample_axis_plain(upsample_axis_plain(x, fy, -2), fx, -1)


def _upsample_int_cuda(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    _lib.check_cuda("x", x, (torch.float32,), ndim=3)
    if not (1 <= fy <= 8 and 1 <= fx <= 8):
        raise ValueError(f"upsample factors must lie in [1, 8], got {fy}, {fx}")
    n, h, w = x.shape
    y = torch.empty((n, h * fy, w * fx), device=x.device, dtype=torch.float32)
    KERNEL.launch(x.data_ptr(), y.data_ptr(), n, h, w, fy, fx)
    return y


def upsample_int(x: torch.Tensor, fy: int, fx: int | None = None) -> torch.Tensor:
    """x (N, h, w) f32 -> (N, fy*h, fx*w) f32.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    fx = fy if fx is None else fx
    if x.is_cuda:
        return _upsample_int_cuda(x, fy, fx)
    if x.device.type == "cpu":
        return upsample_int_plain(x, fy, fx)
    raise ValueError(f"upsample_int: unsupported device {x.device}")
