"""Fused mask-loss reductions, K6 (forward) and K6b (backward).

Replaces ``polyphonicformer_tpu/ops/pallas/mask_loss.py::fused_mask_loss_stats``
(``_fwd_call`` and ``_bwd_call``): one pass over the (N, Q, H, W) mask
logits ``m`` and soft targets ``t`` gives

  stats (N, 2): [0] = sum_q pos_q sum_px valid * BCE(m, t)
                [1] = sum_px rvalid * (logsumexp_q m - m[lbl])
  dice (N, 3, Q): a = sum sig*t*valid, b = sum sig^2*valid, c = sum t^2*valid

with ``rvalid = (lbl >= 0) & (lbl < Q) & (lbl != 255)``, and the gradient
with respect to ``m`` is the analytic one of ``_bwd_kernel`` (the other
inputs are constants of the assignment).  The CUDA kernels are in
``csrc/mask_loss.cu`` (the source note there gives the bound and design);
they take any H and W.  :func:`mask_loss_stats` is a
``torch.autograd.Function``: a CUDA tensor launches the kernels in both
directions, a CPU tensor takes the plain versions, which compute the same
sums with torch ops and write out the same gradient formulas.
"""
from __future__ import annotations

import torch

from . import _lib

IGNORE_LABEL = 255  # fixed, as in the JAX kernel

KERNEL = _lib.Kernel("poly_mask_loss_fwd", [
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32,
    _lib.I64])
KERNEL_BWD = _lib.Kernel("poly_mask_loss_bwd", [
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32,
    _lib.I64])

_TILE = 512  # pixels per forward block (TILE in csrc/mask_loss.cu)


def _sigmoid_softplus(m: torch.Tensor):
    """sigmoid(m) and log1p(exp(-|m|)) from one exp, as the kernel does."""
    e = torch.exp(-m.abs())
    inv = 1.0 / (1.0 + e)
    return torch.where(m >= 0, inv, e * inv), torch.log1p(e)


def _rank_terms(m: torch.Tensor, lbl: torch.Tensor):
    """Per-pixel logsumexp over Q (the kernel's online max and sum, query
    by query), rank validity and the one-hot of the label."""
    q = m.shape[1]
    mx = torch.full_like(m[:, 0], float("-inf"))
    se = torch.zeros_like(m[:, 0])
    for i in range(q):
        x = m[:, i]
        up = x > mx
        se = torch.where(up, se * torch.exp(mx - x) + 1.0, se + torch.exp(x - mx))
        mx = torch.where(up, x, mx)
    lse = mx + torch.log(se)
    rvalid = (lbl >= 0) & (lbl < q) & (lbl != IGNORE_LABEL)
    onehot = torch.arange(q, device=m.device)[None, :, None, None] == lbl[:, None]
    return lse, rvalid, onehot


def mask_loss_stats_plain(m, t, pos, valid, lbl):
    """The forward sums with torch ops: (stats (N, 2), dice (N, 3, Q))."""
    v = valid[:, None]
    sig, sp = _sigmoid_softplus(m)
    bce = (torch.clamp(m, min=0.0) - m * t + sp) * v
    bce_s = (bce.sum(dim=(2, 3)) * pos).sum(dim=1)
    sv = sig * v
    dice = torch.stack([(sv * t).sum(dim=(2, 3)), (sv * sig).sum(dim=(2, 3)),
                        (t * t * v).sum(dim=(2, 3))], dim=1)
    lse, rvalid, onehot = _rank_terms(m, lbl)
    picked = torch.where(onehot, m, 0.0).sum(dim=1)
    rank_s = torch.where(rvalid, lse - picked, 0.0).sum(dim=(1, 2))
    return torch.stack([bce_s, rank_s], dim=1), dice


def mask_loss_grad_plain(m, t, pos, valid, lbl, gstats, gdice):
    """d/dm of ``<gstats, stats> + <gdice, dice>``, written out as
    ``_bwd_kernel`` computes it (c does not depend on m), in the kernel's
    order of operations."""
    sig, _ = _sigmoid_softplus(m)
    v = valid[:, None]
    a1 = ((gstats[:, 0, None, None, None] * pos[:, :, None, None]) * v) * (sig - t)
    inner = gdice[:, 0, :, None, None] * t + (2.0 * gdice[:, 1, :, None, None]) * sig
    a2 = (inner * v) * (sig * (1.0 - sig))
    lse, rvalid, onehot = _rank_terms(m, lbl)
    rv = torch.where(rvalid, gstats[:, 1, None, None], 0.0)[:, None]
    a3 = rv * (torch.exp(m - lse[:, None]) - onehot.float())
    return (a1 + a2) + a3


def _check_inputs(m, t, pos, valid, lbl) -> None:
    _lib.check_cuda("m", m, (torch.float32,), ndim=4)
    n, q, h, w = m.shape
    for name, x, shape, dtype in (("t", t, (n, q, h, w), torch.float32),
                                  ("pos", pos, (n, q), torch.float32),
                                  ("valid", valid, (n, h, w), torch.float32),
                                  ("lbl", lbl, (n, h, w), torch.int32)):
        _lib.check_cuda(name, x, (dtype,))
        if tuple(x.shape) != shape or x.device != m.device:
            raise ValueError(f"{name}: expected {shape} on {m.device}, got "
                             f"{tuple(x.shape)} on {x.device}")


def _stats_cuda(m, t, pos, valid, lbl):
    _check_inputs(m, t, pos, valid, lbl)
    n, q, h, w = m.shape
    hw = h * w
    partial = torch.empty((n, -(-hw // _TILE), 2 + 3 * q), device=m.device,
                          dtype=torch.float32)
    stats = torch.empty((n, 2), device=m.device, dtype=torch.float32)
    dice = torch.empty((n, 3, q), device=m.device, dtype=torch.float32)
    KERNEL.launch(m.data_ptr(), t.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                  lbl.data_ptr(), partial.data_ptr(), stats.data_ptr(), dice.data_ptr(),
                  n, q, hw)
    return stats, dice


def _grad_cuda(m, t, pos, valid, lbl, gstats, gdice):
    _check_inputs(m, t, pos, valid, lbl)
    n, q, h, w = m.shape
    _lib.check_cuda("gstats", gstats, (torch.float32,))
    _lib.check_cuda("gdice", gdice, (torch.float32,))
    if gstats.shape != (n, 2) or gdice.shape != (n, 3, q):
        raise ValueError(f"cotangents {tuple(gstats.shape)}, {tuple(gdice.shape)} do not "
                         f"match {(n, 2)}, {(n, 3, q)}")
    dm = torch.empty_like(m)
    KERNEL_BWD.launch(m.data_ptr(), t.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                      lbl.data_ptr(), gstats.data_ptr(), gdice.data_ptr(), dm.data_ptr(),
                      n, q, h * w)
    return dm


class _MaskLossStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, t, pos, valid, lbl):
        ctx.save_for_backward(m, t, pos, valid, lbl)
        if m.is_cuda:
            return _stats_cuda(m, t, pos, valid, lbl)
        if m.device.type == "cpu":
            return mask_loss_stats_plain(m, t, pos, valid, lbl)
        raise ValueError(f"mask_loss_stats: unsupported device {m.device}")

    @staticmethod
    def backward(ctx, gstats, gdice):
        m, t, pos, valid, lbl = ctx.saved_tensors
        gstats = torch.zeros((m.shape[0], 2), device=m.device) if gstats is None \
            else gstats.contiguous()
        gdice = torch.zeros((m.shape[0], 3, m.shape[1]), device=m.device) if gdice is None \
            else gdice.contiguous()
        fn = _grad_cuda if m.is_cuda else mask_loss_grad_plain
        return fn(m, t, pos, valid, lbl, gstats, gdice), None, None, None, None


def mask_loss_stats(m: torch.Tensor, t: torch.Tensor, pos: torch.Tensor,
                    valid: torch.Tensor, lbl: torch.Tensor):
    """m, t (N, Q, H, W) f32; pos (N, Q) f32; valid (N, H, W) f32; lbl
    (N, H, W) int32.  Returns (stats (N, 2), dice (N, 3, Q)), differentiable
    in ``m`` only."""
    return _MaskLossStats.apply(m, t, pos, valid, lbl)
