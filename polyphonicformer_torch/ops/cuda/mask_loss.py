"""Fused mask-loss reductions, K6 (forward) and K6b (backward).

Replaces ``polyphonicformer_tpu/ops/pallas/mask_loss.py::fused_mask_loss_stats``
(``_fwd_call`` and ``_bwd_call``): one pass over the (N, Q, H, W) mask
logits ``m`` and soft targets ``t`` gives

  stats (N, 2): [0] = sum_q pos_q sum_px valid * BCE(m, t)
                [1] = sum_px rvalid * (logsumexp_q m - m[lbl])
  dice (N, 3, Q): a = sum sig*t*valid, b = sum sig^2*valid, c = sum t^2*valid

with ``rvalid = (lbl >= 0) & (lbl < Q) & (lbl != 255)``, and the per-pixel
logsumexp over Q, ``lse`` (N, H, W), which the backward reads instead of
recomputing it; the gradient with respect to ``m`` is the analytic one of
``_bwd_kernel`` (the other inputs are constants of the assignment).  The
CUDA kernels are in ``csrc/mask_loss.cu`` (the source note there gives the
bound and design); they take any H and W.  :func:`mask_loss_stats` is a
``torch.autograd.Function``: a CUDA tensor launches the kernels in both
directions, a CPU tensor takes the plain versions, which compute the same
sums with torch ops and write out the same gradient formulas; either way
the forward's ``lse`` is saved for the backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib

IGNORE_LABEL = 255  # fixed, as in the JAX kernel

_ARGS = [_lib.P] * 9 + [_lib.I32, _lib.I32, _lib.I64, _lib.I32]
KERNEL = _lib.Kernel("poly_mask_loss_fwd", _ARGS)
KERNEL_BWD = _lib.Kernel("poly_mask_loss_bwd", _ARGS)

# csrc/mask_loss.cu: threads a block, consecutive pixels a thread, partial
# rows a group's last block sums
THREADS, PPT, ROWS_PER_GROUP = 256, 4, 16


class Plan(NamedTuple):
    blocks: int  # forward and backward blocks a problem
    groups: int  # groups of partial rows a problem
    scratch_floats: int  # partial rows, group rows, then (N, groups + 1) u32 tickets


def launch_plan(n: int, q: int, hw: int) -> Plan:
    """The forward's grid and scratch, as ``launch_fwd`` in the source lays
    them out: one partial row of ``2 + 3q`` a block, one a group."""
    blocks = -(-hw // (THREADS * PPT))
    groups = -(-blocks // ROWS_PER_GROUP)
    return Plan(blocks, groups, n * (blocks + groups) * (2 + 3 * q) + n * (groups + 1))


def vector_path(hw: int, *tensors: torch.Tensor) -> bool:
    """The kernels load four pixels as one float4 when every row starts on
    16 bytes; else they take the scalar path."""
    return hw % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in tensors)


def _sigmoid_softplus(m: torch.Tensor):
    """sigmoid(m) and log1p(exp(-|m|)) from one exp, as the kernel does."""
    e = torch.exp(-m.abs())
    inv = 1.0 / (1.0 + e)
    return torch.where(m >= 0, inv, e * inv), torch.log1p(e)


def _rank_masks(q: int, lbl: torch.Tensor):
    """Rank validity (N, H, W) and the one-hot of the label (N, Q, H, W)."""
    rvalid = (lbl >= 0) & (lbl < q) & (lbl != IGNORE_LABEL)
    onehot = torch.arange(q, device=lbl.device)[None, :, None, None] == lbl[:, None]
    return rvalid, onehot


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
    return (mx + torch.log(se), *_rank_masks(q, lbl))


def mask_loss_stats_plain(m, t, pos, valid, lbl):
    """The forward sums with torch ops: (stats (N, 2), dice (N, 3, Q), lse
    (N, H, W))."""
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
    return torch.stack([bce_s, rank_s], dim=1), dice, lse


def mask_loss_grad_plain(m, t, pos, valid, lbl, gstats, gdice, lse=None):
    """d/dm of ``<gstats, stats> + <gdice, dice>``, written out as
    ``_bwd_kernel`` computes it (c does not depend on m), in the kernel's
    order of operations.  ``lse``: the forward's logsumexp; without it, it
    is recomputed from ``m``."""
    sig, _ = _sigmoid_softplus(m)
    v = valid[:, None]
    a1 = ((gstats[:, 0, None, None, None] * pos[:, :, None, None]) * v) * (sig - t)
    inner = gdice[:, 0, :, None, None] * t + (2.0 * gdice[:, 1, :, None, None]) * sig
    a2 = (inner * v) * (sig * (1.0 - sig))
    if lse is None:
        lse, rvalid, onehot = _rank_terms(m, lbl)
    else:
        rvalid, onehot = _rank_masks(m.shape[1], lbl)
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
    plan = launch_plan(n, q, hw)
    scratch = torch.empty(plan.scratch_floats, device=m.device, dtype=torch.float32)
    stats = torch.empty((n, 2), device=m.device, dtype=torch.float32)
    dice = torch.empty((n, 3, q), device=m.device, dtype=torch.float32)
    lse = torch.empty((n, h, w), device=m.device, dtype=torch.float32)
    KERNEL.launch(m.data_ptr(), t.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                  lbl.data_ptr(), lse.data_ptr(), scratch.data_ptr(), stats.data_ptr(),
                  dice.data_ptr(), n, q, hw, int(vector_path(hw, m, t, valid, lbl, lse)))
    return stats, dice, lse


def _grad_cuda(m, t, pos, valid, lbl, gstats, gdice, lse):
    _check_inputs(m, t, pos, valid, lbl)
    n, q, h, w = m.shape
    for name, x, shape in (("gstats", gstats, (n, 2)), ("gdice", gdice, (n, 3, q)),
                           ("lse", lse, (n, h, w))):
        _lib.check_cuda(name, x, (torch.float32,))
        if tuple(x.shape) != shape or x.device != m.device:
            raise ValueError(f"{name}: expected {shape} on {m.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    dm = torch.empty_like(m)
    hw = h * w
    KERNEL_BWD.launch(m.data_ptr(), t.data_ptr(), lse.data_ptr(), pos.data_ptr(),
                      valid.data_ptr(), lbl.data_ptr(), gstats.data_ptr(), gdice.data_ptr(),
                      dm.data_ptr(), n, q, hw,
                      int(vector_path(hw, m, t, lse, valid, lbl, dm)))
    return dm


class _MaskLossStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, t, pos, valid, lbl):
        if m.is_cuda:
            stats, dice, lse = _stats_cuda(m, t, pos, valid, lbl)
        elif m.device.type == "cpu":
            stats, dice, lse = mask_loss_stats_plain(m, t, pos, valid, lbl)
        else:
            raise ValueError(f"mask_loss_stats: unsupported device {m.device}")
        ctx.save_for_backward(m, t, pos, valid, lbl, lse)
        return stats, dice

    @staticmethod
    def backward(ctx, gstats, gdice):
        m, t, pos, valid, lbl, lse = ctx.saved_tensors
        gstats = torch.zeros((m.shape[0], 2), device=m.device) if gstats is None \
            else gstats.contiguous()
        gdice = torch.zeros((m.shape[0], 3, m.shape[1]), device=m.device) if gdice is None \
            else gdice.contiguous()
        fn = _grad_cuda if m.is_cuda else mask_loss_grad_plain
        return fn(m, t, pos, valid, lbl, gstats, gdice, lse), None, None, None, None


def mask_loss_stats(m: torch.Tensor, t: torch.Tensor, pos: torch.Tensor,
                    valid: torch.Tensor, lbl: torch.Tensor):
    """m, t (N, Q, H, W) f32; pos (N, Q) f32; valid (N, H, W) f32; lbl
    (N, H, W) int32.  Returns (stats (N, 2), dice (N, 3, Q)), differentiable
    in ``m`` only."""
    return _MaskLossStats.apply(m, t, pos, valid, lbl)
