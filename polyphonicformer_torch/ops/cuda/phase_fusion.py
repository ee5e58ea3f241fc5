"""Panoptic fusion in phase space, K3.

Replaces ``polyphonicformer_tpu/ops/pallas/phase_fusion.py::phase_fusion``:
for every fy x fx phase of the exact bilinear upsample of the stride-4
candidate maps, the argmax of ``score * prob``, the winner's depth, the
row/column marginals of the argmax regions and the area where
``prob >= 0.5``.  Rows at or beyond ``n_full`` fold into one exact max
channel; where it wins, the pixel gets the sentinel ``nf``.  The CUDA
kernel is ``csrc/phase_fusion.cu`` (one thread per stride-4 pixel and
half of its row phases, the candidates streamed through a ring of
shared-memory slots, the marginals counted per block; the source note there
gives the bound and design), launched as :func:`launch_plan` says.

Both versions store the maps in bf16, pad K to a multiple of 8 (the plain
version with rows of zeros, ``_prep``; the kernel reads the rows past K as
zeros), take f32 scores (not bf16) and lerp rows first, then columns.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_phase_fusion", [
    _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.I32,
    _lib.I32, _lib.I32, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P,
    _lib.I32, _lib.I32, _lib.I32, _lib.I32])

TILE_W = 32  # stride-4 pixels of a tile along x: one warp (csrc/phase_fusion.cu TW)
TILE_H = 8  # stride-4 rows of a tile (TH); a block is (32, 2 * TILE_H) threads
HALO = 8  # bf16 columns of shared tile on each side, one 16-byte chunk
STAGES = 4  # ring slots (STAGES)
CK = 8  # candidates per slot (CK): kp and nf are multiples of 8
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100 (227 KB)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the kernel: ``grid`` (x tiles, y tiles) of TILE_W x
    TILE_H stride-4 pixels, ``threads`` (32, 2 * TILE_H) a block, ``smem``
    bytes of dynamic shared memory."""
    grid: tuple[int, int]
    threads: tuple[int, int]
    smem: int


def launch_plan(kp: int, nf: int, hs: int, ws: int, f: int) -> Plan:
    """The kernel's launch for ``kp`` candidates (``nf`` full) of (hs, ws)
    at factor ``f``: a thread per stride-4 pixel and half of the f row
    phases.  Shared memory: the ring (STAGES slots, each CK candidates of
    TILE_H + 2 rows of TILE_W + 2 HALO bf16), the kp scores, and int counts
    of the tile's TILE_H * f rows, TILE_W * f columns and each warp's area,
    each per full row."""
    slot = CK * (TILE_H + 2) * (TILE_W + 2 * HALO) * 2
    warps = TILE_W * 2 * TILE_H // 32
    smem = STAGES * slot + 4 * kp + 4 * nf * (TILE_H * f + TILE_W * f + warps)
    grid = (-(-ws // TILE_W), -(-hs // TILE_H))
    return Plan(grid, (TILE_W, 2 * TILE_H), smem)


def phase_taps(factor: int) -> list[tuple[int, float, float]]:
    """Per phase: (base offset, w0, w1) as ``phase_fusion.py::_phase_taps``
    computes them (lam rounded to f32 first, then 1 - lam in f32)."""
    import numpy as np

    out = []
    for p in range(factor):
        src = (p + 0.5) / factor - 0.5
        base = int(np.floor(src))
        lam = np.float32(src - base)
        out.append((base, float(np.float32(1) - lam), float(lam)))
    return out


def _rows(kk: int, n_full: int | None) -> tuple[int, int, int]:
    """(kpad, nf, kf): K padded to a multiple of 8, the full rows (n_full
    rounded up to a multiple of 8, at most kpad) and the rows with
    marginals."""
    kpad = (kk + 7) // 8 * 8
    nf = kpad if n_full is None else min((n_full + 7) // 8 * 8, kpad)
    return kpad, nf, min(nf, kk)


def _prep(probs, scores, depth, n_full):
    kk = probs.shape[0]
    kpad, nf, kf = _rows(kk, n_full)

    def pad(x):
        x = x.to(torch.bfloat16)
        if kpad == kk:
            return x.contiguous()
        return torch.cat([x, x.new_zeros((kpad - kk,) + x.shape[1:])])

    s = scores.float()
    if kpad != kk:
        s = torch.cat([s, s.new_zeros(kpad - kk)])
    return pad(probs), s.contiguous(), pad(depth), kpad, nf, kf


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """Edge-clamped shift by d in {-1, 0, 1}: out[i] = x[clamp(i + d)]."""
    if d == 0:
        return x
    n = x.shape[dim]
    if d == -1:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)


def phase_fusion_plain(probs, scores, depth, fy: int = 4, fx: int = 4,
                       n_full: int | None = None):
    """Same contract as :func:`phase_fusion`, in plain tensor ops."""
    kk, hs, ws = probs.shape
    m, s, d, kpad, nf, kf = _prep(probs, scores, depth, n_full)
    m = m.float()
    d = d[:nf].float()
    pruned = nf < kpad
    h, w = hs * fy, ws * fx
    dev = probs.device
    pix = torch.empty((hs, fy, ws, fx), dtype=torch.int32, device=dev)
    dep = torch.empty((hs, fy, ws, fx), dtype=torch.float32, device=dev)
    rowm = torch.zeros((fy, kf, hs), dtype=torch.float32, device=dev)
    colm = torch.zeros((fx, kf, ws), dtype=torch.float32, device=dev)
    oarea = torch.zeros((kf,), dtype=torch.float32, device=dev)
    kidx = torch.arange(kf, device=dev, dtype=torch.int32)[:, None, None]
    rows_m = {b: _shift(m, b, 1) for b in (-1, 0, 1)}
    rows_d = {b: _shift(d, b, 1) for b in (-1, 0, 1)}
    for py, (by, wy0, wy1) in enumerate(phase_taps(fy)):
        vy_m = wy0 * rows_m[by] + wy1 * rows_m[by + 1]
        vy_d = wy0 * rows_d[by] + wy1 * rows_d[by + 1]
        for px, (bx, wx0, wx1) in enumerate(phase_taps(fx)):
            v = wx0 * _shift(vy_m, bx, 2) + wx1 * _shift(vy_m, bx + 1, 2)
            vd = wx0 * _shift(vy_d, bx, 2) + wx1 * _shift(vy_d, bx + 1, 2)
            prob = s[:, None, None] * v
            conf, pa = prob[:nf].max(dim=0)  # first index among ties
            pa = pa.to(torch.int32)
            if pruned:
                pa = torch.where(prob[nf:].amax(dim=0) > conf,
                                 torch.full_like(pa, nf), pa)
            win = pa < nf
            dsel = torch.gather(vd, 0, pa.clamp(max=nf - 1).long()[None])[0]
            pix[:, py, :, px] = pa
            dep[:, py, :, px] = torch.where(win, dsel, torch.zeros_like(dsel))
            region = (kidx == pa[None]).float()  # (kf, hs, ws)
            rowm[py] += region.sum(dim=2)
            colm[px] += region.sum(dim=1)
            oarea += (v[:kf] >= 0.5).float().sum(dim=(1, 2))
    row_marg = rowm.permute(1, 2, 0).reshape(kf, h)  # row r = ys*fy + py
    col_marg = colm.permute(1, 2, 0).reshape(kf, w)
    return pix.reshape(h, w), dep.reshape(h, w), row_marg, col_marg, oarea


def _phase_fusion_cuda(probs, scores, depth, fy, fx, n_full):
    for name, t in (("probs", probs), ("depth", depth)):
        _lib.check_cuda(name, t, (torch.float32, torch.bfloat16), ndim=3,
                        contiguous=False)
    _lib.check_cuda("scores", scores, (torch.float32, torch.bfloat16), ndim=1,
                    contiguous=False)
    if (fy, fx) not in ((2, 2), (4, 4)):
        raise NotImplementedError(f"phase_fusion kernel: factors {fy}x{fx} "
                                  "(built for 2x2 and 4x4)")
    kk, hs, ws = probs.shape
    if depth.shape != probs.shape or scores.shape != (kk,):
        raise ValueError("phase_fusion: probs, depth and scores disagree in shape")
    # bf16 storage and f32 scores as _prep, the padding rows left to the
    # kernel (it reads them as zeros)
    m, d = (t.to(torch.bfloat16).contiguous() for t in (probs, depth))
    s = scores.float().contiguous()
    kpad, nf, kf = _rows(kk, n_full)
    plan = launch_plan(kpad, nf, hs, ws, fy)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"phase_fusion kernel: {nf} full rows need {plan.smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    if plan.grid[1] > 65535 or hs * ws * CK >= 2 ** 31:
        raise ValueError(f"phase_fusion kernel: {hs}x{ws} exceeds its grid or 32-bit offsets")
    h, w = hs * fy, ws * fx
    dev = probs.device
    pix = torch.empty((h, w), dtype=torch.int32, device=dev)
    dep = torch.empty((h, w), dtype=torch.float32, device=dev)
    counts = torch.zeros((kf * (h + w + 1),), dtype=torch.float32, device=dev)  # one memset
    rowm = counts[:kf * h].view(kf, h)
    colm = counts[kf * h:kf * (h + w)].view(kf, w)
    oarea = counts[kf * (h + w):]
    vec = ws % 8 == 0 and m.data_ptr() % 16 == 0
    KERNEL.launch(m.data_ptr(), d.data_ptr(), s.data_ptr(), kk, kpad, nf, kf, hs, ws,
                  fy, fx, pix.data_ptr(), dep.data_ptr(), rowm.data_ptr(), colm.data_ptr(), oarea.data_ptr(),
                  *plan.grid, plan.smem, int(vec))
    return pix, dep, rowm, colm, oarea


def phase_fusion(probs: torch.Tensor, scores: torch.Tensor, depth: torch.Tensor,
                 fy: int = 4, fx: int = 4, n_full: int | None = None):
    """probs/depth: (K, hs, ws) stride-4 candidate maps; scores: (K,).

    Returns ``pix`` (H, W) int32 winning candidate (sentinel ``nf`` where a
    folded row wins), ``dep`` (H, W) f32 winner depth (0 at the sentinel),
    ``row_marg`` (kf, H), ``col_marg`` (kf, W) and ``oarea`` (kf,) f32 with
    ``kf = min(nf, K)``.  A CUDA tensor launches the kernel; a CPU tensor
    takes the plain version.
    """
    if probs.is_cuda:
        return _phase_fusion_cuda(probs, scores, depth, fy, fx, n_full)
    if probs.device.type == "cpu":
        return phase_fusion_plain(probs, scores, depth, fy, fx, n_full)
    raise ValueError(f"phase_fusion: unsupported device {probs.device}")
