"""Panoptic + depth fusion without data-dependent loops; mirrors
``polyphonicformer_tpu/infer/panoptic.py``.

Three branches, as in JAX: at an integer factor <= 8 the bf16 serving
branch, where the phase-space merge is the K3 kernel
(``ops/cuda/phase_fusion.py``), and the f32 reference-exact phase branch in
plain tensor ops; at any other factor (an image whose size is not a
multiple of the padded stride-4 logits' x4) the general branch, which
upsamples every candidate to full resolution.  The maps are rendered
by the K4 kernel (``ops/cuda/map_render.py``).  Every sort is stable, so
ties keep index order as ``jnp.argsort`` and ``jax.lax.top_k`` do.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.cuda.map_render import render_maps
from ..ops.cuda.phase_fusion import phase_fusion
from ..ops.depth import depth_act, sigmoid
from ..ops.resize import resize_bilinear, resize_bilinear_matmul


class PanopticResult(NamedTuple):
    """Per-image fused outputs; candidate arrays are ordered
    [things (top max_per_img), stuff (score-sorted)]."""

    panoptic: torch.Tensor | None  # (H, W) int32 segment ids, 0 = void
    semantic: torch.Tensor | None  # (H, W) int32 class ids, num_classes = void
    depth: torch.Tensor | None  # (H, W) float32 final depth
    depth_basic: torch.Tensor  # (H, W) float32 dense (initial) depth
    keep: torch.Tensor  # (K,) bool
    seg_ids: torch.Tensor  # (K,) int32
    labels: torch.Tensor  # (K,) int32
    scores: torch.Tensor  # (K,) float32
    is_thing: torch.Tensor  # (K,) bool
    instance_ids: torch.Tensor  # (K,) int32
    areas: torch.Tensor  # (K,) int32 argmax-region areas
    masks: torch.Tensor | None  # (K, H, W) bool; None with emit_marginals
    row_marg: torch.Tensor | None = None  # (K, H) float32
    col_marg: torch.Tensor | None = None  # (K, W) float32
    pix_arg: torch.Tensor | None = None  # (H, W) int32 winning candidate
    depth_pix: torch.Tensor | None = None  # (H, W) float32, with defer_maps
    n_render: int | None = None  # rows that can render; None = all K


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, descending, ties in index order."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def _phase_tap_weights(factor: int):
    """Per phase (base offset, (w0, w1)) in float64, as the JAX branch."""
    p = np.arange(factor)
    src = (p + 0.5) / factor - 0.5
    base = np.floor(src).astype(int)
    lam = src - base
    return [(int(base[i]), (float(1 - lam[i]), float(lam[i]))) for i in range(factor)]


def _shifted(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shift of the last two axes by (dy, dx) in {-1, 0, 1}."""
    if dy == -1:
        x = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    elif dy == 1:
        x = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    if dx == -1:
        x = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    elif dx == 1:
        x = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return x


def _phase_upsample(x: torch.Tensor, py: int, px: int, fy: int, fx: int) -> torch.Tensor:
    """One (py, px) phase of the exact (fy, fx) bilinear upsample: a 4-tap
    lerp of edge-clamped shifts at the input resolution."""
    by, (wy0, wy1) = _phase_tap_weights(fy)[py]
    bx, (wx0, wx1) = _phase_tap_weights(fx)[px]
    return ((wy0 * wx0) * _shifted(x, by, bx) + (wy0 * wx1) * _shifted(x, by, bx + 1)
            + (wy1 * wx0) * _shifted(x, by + 1, bx)
            + (wy1 * wx1) * _shifted(x, by + 1, bx + 1))


def _interleave_phases(tiles, fy: int, fx: int) -> torch.Tensor:
    """fy*fx (h, w) tiles ordered (py, px) -> (h*fy, w*fx)."""
    h, w = tiles[0].shape[-2:]
    stack = torch.stack(tiles).reshape(fy, fx, h, w)
    return stack.permute(2, 0, 3, 1).reshape(h * fy, w * fx)


def _phase_merge_f32(masks_small, scores_d, depth_small, fy: int, fx: int):
    """The reference-exact phase branch (JAX ``fuse_panoptic`` ``elif
    phased``): argmax, marginals, areas and winner depth per phase."""
    kk, hs, ws = masks_small.shape
    dev = masks_small.device
    orig_area = torch.zeros((kk,), dtype=torch.int32, device=dev)
    pix_tiles, depth_tiles = [], []
    rowm = [torch.zeros((kk, hs), device=dev) for _ in range(fy)]
    colm = [torch.zeros((kk, ws), device=dev) for _ in range(fx)]
    kidx = torch.arange(kk, device=dev)[:, None, None]
    for py in range(fy):
        for px in range(fx):
            up = _phase_upsample(masks_small, py, px, fy, fx)
            pa = torch.argmax(scores_d[:, None, None] * up, dim=0)
            region = (pa[None] == kidx).float()
            rowm[py] += region.sum(dim=2)
            colm[px] += region.sum(dim=1)
            orig_area += (up >= 0.5).sum(dim=(1, 2)).to(torch.int32)
            dup = _phase_upsample(depth_small, py, px, fy, fx)
            depth_tiles.append(torch.gather(dup, 0, pa[None])[0].float())
            pix_tiles.append(pa.to(torch.int32))
    pix_arg = _interleave_phases(pix_tiles, fy, fx)
    depth_pix = _interleave_phases(depth_tiles, fy, fx)
    row_marg = torch.stack(rowm, dim=-1).reshape(kk, hs * fy)  # row = ys*fy + py
    col_marg = torch.stack(colm, dim=-1).reshape(kk, ws * fx)
    return pix_arg, depth_pix, row_marg, col_marg, orig_area


def _general_merge(masks_small, scores_d, depth_small, out_hw, precise: bool):
    """The general branch (JAX ``fuse_panoptic``'s last ``else``): every
    candidate upsampled to (H, W) in the fusion dtype, then the argmax,
    marginals, areas and winner depth at full resolution."""
    kk = masks_small.shape[0]
    masks = resize_bilinear_matmul(masks_small, out_hw, precise=precise)
    depth_cand = resize_bilinear_matmul(depth_small, out_hw, precise=precise)
    pix_arg = torch.argmax(scores_d[:, None, None] * masks, dim=0)
    region = pix_arg[None] == torch.arange(kk, device=masks.device)[:, None, None]
    row_marg = region.sum(dim=2).float()
    col_marg = region.sum(dim=1).float()
    orig_area = (masks >= 0.5).sum(dim=(1, 2)).to(torch.int32)
    depth_pix = torch.gather(depth_cand, 0, pix_arg[None])[0].float()
    return pix_arg.to(torch.int32), depth_pix, row_marg, col_marg, orig_area


def fuse_panoptic(cfg, cls_probs: torch.Tensor, mask_logits: torch.Tensor,
                  depth_logits: torch.Tensor, depth_init_logits: torch.Tensor,
                  out_hw: Tuple[int, int], fusion_dtype=torch.float32,
                  emit_marginals: bool = False, defer_maps: bool = False) -> PanopticResult:
    """Single image, final stage.  cls_probs (Q, C) sigmoid probabilities;
    mask_logits / depth_logits (Q, h, w) at stride 4; depth_init_logits
    (h', w'); out_hw the image size (H, W).  fusion_dtype bfloat16 takes the
    K3 kernel path; float32 is reference-exact.  emit_marginals returns the
    row/column marginals and pixel argmax instead of the (K, H, W) masks;
    defer_maps leaves the maps to the caller (who renders them with the
    track ids, ``ops/cuda/map_render.py``)."""
    nt, ns, npp = cfg.num_thing_classes, cfg.num_stuff_classes, cfg.num_proposals
    h, w = out_hw
    dev = cls_probs.device

    k = cfg.max_per_img
    scores_t, top_idx = top_k(cls_probs[:npp, :nt].reshape(-1), k)
    mask_idx = torch.div(top_idx, nt, rounding_mode="floor")
    labels_t = (top_idx % nt).to(torch.int32)
    stuff_scores = torch.diagonal(cls_probs[npp:, nt:])
    scores_s, order_s = torch.sort(stuff_scores, descending=True, stable=True)
    labels_s = (order_s + nt).to(torch.int32)
    cand_rows = torch.cat([mask_idx, npp + order_s])
    scores = torch.cat([scores_t, scores_s])
    labels = torch.cat([labels_t, labels_s])
    kk = k + ns
    is_thing = torch.arange(kk, device=dev) < k

    hs, ws = mask_logits.shape[-2:]
    phased = h % hs == 0 and w % ws == 0 and 1 <= h // hs <= 8 and 1 <= w // ws <= 8
    fy, fx = h // hs, w // ws
    use_kernel = phased and fusion_dtype != torch.float32
    n_render = None
    if use_kernel and cfg.fusion_full_things < k:
        # fusion prune: [top things, stuff] first; the rest fold into the
        # kernel's max channel (phase_fusion n_full)
        ke_t = cfg.fusion_full_things
        perm = torch.cat([torch.arange(ke_t, device=dev), k + torch.arange(ns, device=dev),
                          torch.arange(ke_t, k, device=dev)])
        cand_rows, scores, labels = cand_rows[perm], scores[perm], labels[perm]
        is_thing = perm < k
        n_render = min((ke_t + ns + 7) // 8 * 8, kk)

    masks_small = sigmoid(mask_logits[cand_rows].to(fusion_dtype))
    depth_small = depth_act(depth_logits[cand_rows].to(fusion_dtype), cfg.depth_act_mode)
    depth_basic = resize_bilinear(
        depth_act(depth_init_logits.float(), cfg.depth_act_mode)[None], (h, w))[0]

    if use_kernel:
        pix_arg, depth_pix, row_marg, col_marg, oarea = phase_fusion(
            masks_small, scores, depth_small, fy, fx, n_full=n_render)
        if row_marg.shape[0] < kk:  # pruned rows: zero marginals, never kept
            pad = kk - row_marg.shape[0]
            row_marg = torch.cat([row_marg, row_marg.new_zeros((pad, h))])
            col_marg = torch.cat([col_marg, col_marg.new_zeros((pad, w))])
            oarea = torch.cat([oarea, oarea.new_zeros(pad)])
        orig_area = oarea.to(torch.int32)
    elif phased:
        pix_arg, depth_pix, row_marg, col_marg, orig_area = _phase_merge_f32(
            masks_small, scores.to(fusion_dtype), depth_small, fy, fx)
    else:
        pix_arg, depth_pix, row_marg, col_marg, orig_area = _general_merge(
            masks_small, scores.to(fusion_dtype), depth_small, (h, w),
            precise=fusion_dtype == torch.float32)
    mask_area = row_marg.sum(dim=1).to(torch.int32)

    score_ok = (~is_thing) | (scores >= cfg.instance_score_thr)
    area_ok = (mask_area > 0) & (orig_area > 0)
    ratio_ok = mask_area.float() >= cfg.overlap_thr * orig_area.float()
    keep = score_ok & area_ok & ratio_ok

    # segment ids in descending score order
    order = torch.argsort(-scores, stable=True)
    seg_ids = torch.zeros((kk,), dtype=torch.int32, device=dev)
    seg_ids[order] = torch.cumsum(keep[order].to(torch.int32), dim=0).to(torch.int32)
    seg_ids = torch.where(keep, seg_ids, torch.zeros_like(seg_ids))

    panoptic = semantic = depth = None
    if not defer_maps:
        nr = kk if n_render is None else n_render
        semantic, panoptic, depth, _ = render_maps(
            pix_arg, depth_pix, depth_basic, labels[:nr], seg_ids[:nr], keep[:nr],
            torch.zeros_like(seg_ids[:nr]), cfg.num_classes)
    seg_masks = None
    if not emit_marginals:
        seg_masks = (pix_arg[None] == torch.arange(kk, device=dev)[:, None, None]) \
            & keep[:, None, None]
    return PanopticResult(
        panoptic=panoptic, semantic=semantic, depth=depth, depth_basic=depth_basic,
        keep=keep, seg_ids=seg_ids, labels=labels, scores=scores, is_thing=is_thing,
        instance_ids=torch.arange(kk, dtype=torch.int32, device=dev), areas=mask_area,
        masks=seg_masks,
        row_marg=row_marg if emit_marginals else None,
        col_marg=col_marg if emit_marginals else None,
        pix_arg=pix_arg if emit_marginals else None,
        depth_pix=depth_pix if defer_maps else None, n_render=n_render)


def segments_info_host(res: PanopticResult, num_thing_classes: int):
    """The reference's ``segments_info`` list from the candidate arrays."""
    keep = res.keep.cpu().numpy()
    scores = res.scores.cpu().numpy()
    seg_ids = res.seg_ids.cpu().numpy()
    is_thing = res.is_thing.cpu().numpy()
    labels = res.labels.cpu().numpy()
    inst = res.instance_ids.cpu().numpy()
    areas = res.areas.cpu().numpy()
    out = []
    for kidx in np.argsort(-scores, kind="stable"):
        if not keep[kidx]:
            continue
        entry = {"id": int(seg_ids[kidx]), "isthing": bool(is_thing[kidx]),
                 "category_id": int(labels[kidx])}
        if entry["isthing"]:
            entry["score"] = float(scores[kidx])
            entry["instance_id"] = int(inst[kidx])
        else:
            entry["area"] = int(areas[kidx])
        out.append(entry)
    return out
