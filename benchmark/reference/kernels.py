"""The arithmetic of the port's hand-written kernels in plain tensor ops.

Each function computes what one ``poly::`` op of the program computes, with
ordinary autograd for the gradients: hard-mask pooling (K1), the exact
integer bilinear upsample (K2, its backward K2b by autograd), the phase-space
fusion (K3), the map render (K4), the exact linear-sum assignment (K5, by
scipy on the host), the mask, dice and rank-loss sums (K6, K6b by autograd)
and window attention (K7 on partitioned windows, K8 on the image layout).
Rounding follows the kernels where the configuration's precision is set by
it: K7 rounds the probabilities to the input's dtype before P V, K8 keeps
them in f32, the fusion reads its candidates in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

IGNORE_LABEL = 255


def masked_pool(mask_logits: torch.Tensor, feats: torch.Tensor,
                thr: float = 0.5) -> torch.Tensor:
    """mask_logits (B, N, h, w), feats (B, h, w, C) -> (B, N, C) f32 of
    ``sum_hw [sigmoid(m) > thr] * f``; no gradient reaches the logits."""
    hard = (torch.sigmoid(mask_logits.float()) > thr).float()
    return torch.einsum("bnhw,bhwc->bnc", hard, feats.float())


def _taps(factor: int):
    """Per output phase: (base offset, w0, w1), the lerp weight in float64
    rounded to f32."""
    out = []
    for p in range(factor):
        src = (p + 0.5) / factor - 0.5
        base = int(np.floor(src))
        lam = src - base
        out.append((base, float(np.float32(1.0 - lam)), float(np.float32(lam))))
    return out


def _upsample_axis(x: torch.Tensor, factor: int, dim: int) -> torch.Tensor:
    x = x.movedim(dim, -1)
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    phases = [w0 * left + w1 * x if base == -1 else w0 * x + w1 * right
              for base, w0, w1 in _taps(factor)]
    out = torch.stack(phases, dim=-1).reshape(*x.shape[:-1], x.shape[-1] * factor)
    return out.movedim(-1, dim)


def upsample_int(x: torch.Tensor, fy: int, fx: int | None = None) -> torch.Tensor:
    """Half-pixel bilinear upsample of (N, h, w) f32 by integer factors, edge
    clamped: (N, fy*h, fx*w)."""
    return _upsample_axis(_upsample_axis(x, fy, -2), fy if fx is None else fx, -1)


def _fusion_taps(factor: int):
    out = []
    for p in range(factor):
        src = (p + 0.5) / factor - 0.5
        base = int(np.floor(src))
        lam = np.float32(src - base)
        out.append((base, float(np.float32(1) - lam), float(lam)))
    return out


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """Edge-clamped shift by d in {-1, 0, 1}: out[i] = x[clamp(i + d)]."""
    if d == 0:
        return x
    n = x.shape[dim]
    if d == -1:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)


def phase_fusion(probs, scores, depth, fy: int = 4, fx: int = 4, n_full: int | None = None):
    """probs/depth (K, hs, ws) stride-4 candidate maps, read in bf16; scores
    (K,).  Per full-resolution pixel the winning candidate of ``score *
    upsample(prob)`` (the first among ties; ``nf`` where a row beyond the
    first ``nf`` wins) and its upsampled depth (0 there); per candidate of
    the first ``kf`` its row and column counts of won pixels and its area
    of upsampled probability >= 0.5.  ``nf`` is ``n_full`` rounded up to 8,
    at most K rounded up to 8; ``kf = min(nf, K)``."""
    kk, hs, ws = probs.shape
    kpad = (kk + 7) // 8 * 8
    nf = kpad if n_full is None else min((n_full + 7) // 8 * 8, kpad)
    kf = min(nf, kk)

    def pad(x):
        x = x.to(torch.bfloat16)
        return x if kpad == kk else torch.cat([x, x.new_zeros((kpad - kk,) + x.shape[1:])])

    s = scores.float()
    if kpad != kk:
        s = torch.cat([s, s.new_zeros(kpad - kk)])
    m = pad(probs).float()
    d = pad(depth)[:nf].float()
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
    for py, (by, wy0, wy1) in enumerate(_fusion_taps(fy)):
        vy_m = wy0 * rows_m[by] + wy1 * rows_m[by + 1]
        vy_d = wy0 * rows_d[by] + wy1 * rows_d[by + 1]
        for px, (bx, wx0, wx1) in enumerate(_fusion_taps(fx)):
            v = wx0 * _shift(vy_m, bx, 2) + wx1 * _shift(vy_m, bx + 1, 2)
            vd = wx0 * _shift(vy_d, bx, 2) + wx1 * _shift(vy_d, bx + 1, 2)
            prob = s[:, None, None] * v
            conf, pa = prob[:nf].max(dim=0)
            pa = pa.to(torch.int32)
            if pruned:
                pa = torch.where(prob[nf:].amax(dim=0) > conf, torch.full_like(pa, nf), pa)
            win = pa < nf
            dsel = torch.gather(vd, 0, pa.clamp(max=nf - 1).long()[None])[0]
            pix[:, py, :, px] = pa
            dep[:, py, :, px] = torch.where(win, dsel, torch.zeros_like(dsel))
            region = (kidx == pa[None]).float()
            rowm[py] += region.sum(dim=2)
            colm[px] += region.sum(dim=1)
            oarea += (v[:kf] >= 0.5).float().sum(dim=(1, 2))
    row_marg = rowm.permute(1, 2, 0).reshape(kf, h)
    col_marg = colm.permute(1, 2, 0).reshape(kf, w)
    return pix.reshape(h, w), dep.reshape(h, w), row_marg, col_marg, oarea


def render_maps(pix, depth_sel, depth_basic, labels, seg_ids, keep, track_ids,
                num_classes: int):
    """(semantic, panoptic, depth, track) maps: a kept winner gives its
    label, segment id and depth_sel, otherwise num_classes, 0 and
    depth_basic; track is the winner's track id inside [0, K), else 0."""
    k = labels.shape[0]
    inside = (pix >= 0) & (pix < k)
    idx = torch.where(inside, pix, torch.zeros_like(pix)).long()
    kept = inside & keep.bool()[idx]
    semantic = torch.where(kept, labels.to(torch.int32)[idx], torch.full_like(pix, num_classes))
    panoptic = torch.where(kept, seg_ids.to(torch.int32)[idx], torch.zeros_like(pix))
    depth = torch.where(kept, depth_sel, depth_basic)
    track = torch.where(inside, track_ids.to(torch.int32)[idx], torch.zeros_like(pix))
    return semantic, panoptic, depth, track


def solve_lsa(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """costs (N, G, P) with G <= P, valid (N, G) -> (N, G) int32 column of
    each valid row (-1 for invalid rows): scipy's exact rectangular
    assignment over the valid rows, invalid rows' costs 0 and non-finite
    entries clamped to +-1e8 first."""
    from scipy.optimize import linear_sum_assignment

    cost = torch.where(valid[:, :, None], costs.float(), 0.0)
    cost = torch.nan_to_num(cost, nan=1e8, posinf=1e8, neginf=-1e8).cpu().numpy()
    ok = valid.cpu().numpy()
    out = np.full(ok.shape, -1, np.int32)
    for n in range(cost.shape[0]):
        rows = np.flatnonzero(ok[n])
        if rows.size:
            r, c = linear_sum_assignment(cost[n][rows])
            out[n, rows[r]] = c
    return torch.from_numpy(out).to(costs.device)


def mask_loss_stats(m: torch.Tensor, t: torch.Tensor, pos: torch.Tensor,
                    valid: torch.Tensor, lbl: torch.Tensor):
    """m, t (N, Q, H, W) f32; pos (N, Q); valid (N, H, W); lbl (N, H, W).
    Returns (stats (N, 2): the positive rows' pixel BCE sum and the rank
    cross-entropy sum, dice (N, 3, Q): sum(sig t), sum(sig^2), sum(t^2) over
    valid pixels), differentiable in m."""
    v = valid[:, None]
    sig = torch.sigmoid(m)
    bce = (torch.clamp(m, min=0.0) - m * t + torch.log1p(torch.exp(-m.abs()))) * v
    bce_s = (bce.sum(dim=(2, 3)) * pos).sum(dim=1)
    sv = sig * v
    dice = torch.stack([(sv * t).sum(dim=(2, 3)), (sv * sig).sum(dim=(2, 3)),
                        (t * t * v).sum(dim=(2, 3))], dim=1)
    q = m.shape[1]
    rvalid = (lbl >= 0) & (lbl < q) & (lbl != IGNORE_LABEL)
    onehot = torch.arange(q, device=lbl.device)[None, :, None, None] == lbl[:, None]
    picked = torch.where(onehot, m, 0.0).sum(dim=1)
    rank = torch.where(rvalid, torch.logsumexp(m, dim=1) - picked, 0.0).sum(dim=(1, 2))
    return torch.stack([bce_s, rank], dim=1), dice


def _attend(q, k, v, bias, mask, p_dtype) -> torch.Tensor:
    """q, k, v (nw, L, h, hd) f32; bias (h, L, L); mask (ntypes, L, L),
    window w taking ``mask[w % ntypes]``, or None -> (nw, L, h*hd) f32."""
    nw, l, h, hd = q.shape
    attn = torch.einsum("wqhd,wkhd->whqk", q, k) * (1.0 / float(hd) ** 0.5)
    attn = attn + bias[None]
    if mask is not None:
        nt = mask.shape[0]
        attn = (attn.reshape(nw // nt, nt, h, l, l) + mask[None, :, None]).reshape(nw, h, l, l)
    p = torch.softmax(attn, dim=-1).to(p_dtype).float()
    return torch.einsum("whqk,wkhd->wqhd", p, v).reshape(nw, l, h * hd)


def _split_heads(x: torch.Tensor, num_heads: int):
    nw, l, c3 = x.shape
    c = c3 // 3
    return [x[..., i * c:(i + 1) * c].reshape(nw, l, num_heads, c // num_heads).float()
            for i in range(3)]


def window_attn_math(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                     num_heads: int) -> torch.Tensor:
    """Attention inside partitioned windows: qkv (nw, L, 3C) -> (nw, L, C)
    in qkv's dtype, probabilities rounded to that dtype before P V."""
    q, k, v = _split_heads(qkv, num_heads)
    return _attend(q, k, v, bias.float(), None if mask is None else mask.float(),
                   qkv.dtype).to(qkv.dtype)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                     num_heads: int, ws: int) -> torch.Tensor:
    """Attention inside ws x ws windows of the image layout: qkv (B, Hp, Wp,
    3C) -> (B, Hp, Wp, C) in qkv's dtype, probabilities kept in f32."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    x = qkv.float().reshape(b, hp // ws, ws, wp // ws, ws, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = _split_heads(x.reshape(-1, ws * ws, c3), num_heads)
    out = _attend(q, k, v, bias.float(), None if mask is None else mask.float(), torch.float32)
    out = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hp, wp, c).to(qkv.dtype)
