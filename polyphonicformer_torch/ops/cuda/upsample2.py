"""Exact integer-factor bilinear upsample, K2 (forward) and K2b (backward).

Replaces ``polyphonicformer_tpu/ops/pallas/upsample2.py::_call_fwd`` and
``_call_bwd`` (``upsample_int_pallas`` / ``upsample2_pallas`` and its custom
VJP): align_corners=False with edge replication, in f32, rows first and
then columns with the phase weights of ``ops/resize.py::_phase_weights``;
the gradient is the exact transposed stencil (``_down_axis``), columns
first and then rows.  The CUDA kernels are in ``csrc/upsample.cu`` (forward:
4 source columns of one source row per thread, float4 loads and stores,
the phase weights of :func:`phase_weights` handed in by the host, factors 2
and 4 specialised; backward: 4 source columns over a band of 2 source rows
per thread, each gradient row loaded and column-passed once, the same
weights, factors 2 and 4 specialised and a generic kernel for the others;
the source notes there give the bound and design).  :func:`upsample_int` is a
``torch.autograd.Function``: a CUDA tensor launches the kernels in both
directions, a CPU tensor takes the plain versions in both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_upsample_int", [
    _lib.P, _lib.P, _lib.I64, _lib.I32, _lib.I32, _lib.I32, _lib.I32,
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32])
KERNEL_BWD = _lib.Kernel("poly_upsample_int_bwd", [
    _lib.P, _lib.P, _lib.I64, _lib.I32, _lib.I32, _lib.I32, _lib.I32,
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32])


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


@functools.lru_cache(maxsize=None)
def _phase_args(factor: int) -> tuple:
    """The kernel's view of :func:`phase_weights`: host arrays of the base
    offsets (int32) and of the (w0, w1) pairs (f32), kept alive here."""
    table = phase_weights(factor)
    bases = (ctypes.c_int * factor)(*(b for b, _, _ in table))
    weights = (ctypes.c_float * (2 * factor))(*(w for _, w0, w1 in table for w in (w0, w1)))
    return bases, weights


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


def downsample_axis_plain(g: torch.Tensor, factor: int, dim: int) -> torch.Tensor:
    """The transposed stencil of :func:`upsample_axis_plain` along ``dim``,
    written out as ``_down_axis`` computes it: per phase, the gradient of
    the phase's own tap, then of the neighbour's (0 beyond the edge), then
    the clamp term at the first or last index, each multiply and add a
    separate f32 op."""
    g = g.movedim(dim, -1)
    n = g.shape[-1] // factor
    s = g.reshape(*g.shape[:-1], n, factor)
    zeros = torch.zeros_like(s[..., :1, :])
    s_lo = torch.cat([zeros, s[..., :-1, :]], dim=-2)  # s_lo[i] = s[i-1]
    s_hi = torch.cat([s[..., 1:, :], zeros], dim=-2)  # s_hi[i] = s[i+1]
    idx = torch.arange(n, device=g.device)
    first, last = idx == 0, idx == n - 1
    dx = torch.zeros_like(s[..., 0])
    for p, (base, w0, w1) in enumerate(phase_weights(factor)):
        gp = s[..., p]
        if base == -1:  # out_p[i] = w0 x[i-1] + w1 x[i]; clamp at i = 0
            dx = dx + w1 * gp + w0 * s_hi[..., p]
            dx = dx + torch.where(first, w0 * gp, 0.0)
        else:  # out_p[i] = w0 x[i] + w1 x[i+1]; clamp at i = n-1
            dx = dx + w0 * gp + w1 * s_lo[..., p]
            dx = dx + torch.where(last, w1 * gp, 0.0)
    return dx.movedim(-1, dim)


def upsample_int_bwd_plain(g: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """g (N, fy*h, fx*w) f32 -> (N, h, w) f32: columns, then rows."""
    return downsample_axis_plain(downsample_axis_plain(g, fx, -1), fy, -2)


def _check_factors(fy: int, fx: int) -> None:
    if not (1 <= fy <= 8 and 1 <= fx <= 8):
        raise ValueError(f"upsample factors must lie in [1, 8], got {fy}, {fx}")


def _upsample_int_cuda(x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    _lib.check_cuda("x", x, (torch.float32,), ndim=3)
    _check_factors(fy, fx)
    n, h, w = x.shape
    if n > 65535:
        raise ValueError(f"upsample_int: {n} images exceed the kernel's grid (65535)")
    y = torch.empty((n, h * fy, w * fx), device=x.device, dtype=torch.float32)
    (by, wy), (bx, wx) = _phase_args(fy), _phase_args(fx)
    vec = w % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    KERNEL.launch(x.data_ptr(), y.data_ptr(), n, h, w, fy, fx, ctypes.addressof(by),
                  ctypes.addressof(wy), ctypes.addressof(bx), ctypes.addressof(wx), int(vec))
    return y


def _upsample_int_bwd_cuda(g: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    _lib.check_cuda("g", g, (torch.float32,), ndim=3)
    _check_factors(fy, fx)
    n, fh, fw = g.shape
    if fh % fy or fw % fx:
        raise ValueError(f"gradient {tuple(g.shape)} is not a x({fy}, {fx}) upsample")
    if n > 65535:
        raise ValueError(f"upsample_int_bwd: {n} images exceed the kernel's grid (65535)")
    h, w = fh // fy, fw // fx
    dx = torch.empty((n, h, w), device=g.device, dtype=torch.float32)
    (by, wy), (bx, wx) = _phase_args(fy), _phase_args(fx)
    vec = w % 4 == 0 and g.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
    KERNEL_BWD.launch(g.data_ptr(), dx.data_ptr(), n, h, w, fy, fx, ctypes.addressof(by),
                      ctypes.addressof(wy), ctypes.addressof(bx), ctypes.addressof(wx),
                      int(vec))
    return dx


def _on(x: torch.Tensor, cuda_fn, plain_fn, *args):
    """A CUDA tensor launches the kernel; a CPU tensor takes the plain version."""
    if x.is_cuda:
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"upsample_int: unsupported device {x.device}")


class _UpsampleInt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
        ctx.factors = (fy, fx)
        return _on(x, _upsample_int_cuda, upsample_int_plain, fy, fx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        fy, fx = ctx.factors
        return _on(g.contiguous(), _upsample_int_bwd_cuda, upsample_int_bwd_plain,
                   fy, fx), None, None


def upsample_int(x: torch.Tensor, fy: int, fx: int | None = None) -> torch.Tensor:
    """x (N, h, w) f32 -> (N, fy*h, fx*w) f32, differentiable in ``x``.  A
    CUDA tensor launches the kernels (forward K2, backward K2b); a CPU
    tensor takes the plain versions."""
    return _UpsampleInt.apply(x, fy, fy if fx is None else fx)
