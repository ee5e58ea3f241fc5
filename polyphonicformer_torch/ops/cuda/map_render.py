"""Final map rendering, K4: semantic, panoptic, depth and track maps from
the fusion's per-pixel winning candidate.

Replaces ``polyphonicformer_tpu/ops/pallas/map_render.py::render_maps``.
The CUDA kernel is ``csrc/map_render.cu``: one thread per pixel with the
(K,) tables in shared memory, looking the integers up directly (the TPU
kernel's f32 code packing is gone; the source note there gives the bound).
A winner outside [0, K), such as the fusion's sentinel, renders void.  The
entry is the custom op ``poly::render_maps``.
"""
from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_map_render", [
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32,
    _lib.I64, _lib.P, _lib.P, _lib.P, _lib.P])


def render_maps_plain(pix, depth_sel, depth_basic, labels, seg_ids, keep,
                      track_ids, num_classes: int):
    """Same contract as :func:`render_maps`, in plain tensor ops."""
    k = labels.shape[0]
    inside = (pix >= 0) & (pix < k)
    idx = torch.where(inside, pix, torch.zeros_like(pix)).long()
    kept = inside & keep.bool()[idx]
    semantic = torch.where(kept, labels.to(torch.int32)[idx],
                           torch.full_like(pix, num_classes))
    panoptic = torch.where(kept, seg_ids.to(torch.int32)[idx], torch.zeros_like(pix))
    depth = torch.where(kept, depth_sel, depth_basic)
    track = torch.where(inside, track_ids.to(torch.int32)[idx], torch.zeros_like(pix))
    return semantic, panoptic, depth, track


def _render_maps_cuda(pix, depth_sel, depth_basic, labels, seg_ids, keep,
                      track_ids, num_classes):
    _lib.check_cuda("pix", pix, (torch.int32,), ndim=2)
    for name, t in (("depth_sel", depth_sel), ("depth_basic", depth_basic)):
        _lib.check_cuda(name, t, (torch.float32,), ndim=2)
        if t.shape != pix.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != pix {tuple(pix.shape)}")
    k = labels.shape[0]
    tables = []
    for name, t in (("labels", labels), ("seg_ids", seg_ids), ("keep", keep),
                    ("track_ids", track_ids)):
        _lib.check_cuda(name, t, (torch.int32, torch.int64, torch.bool), ndim=1,
                        contiguous=False)
        if t.shape[0] != k:
            raise ValueError(f"{name}: {t.shape[0]} entries, labels has {k}")
        tables.append(t.to(torch.int32).contiguous())
    if k == 0 or 4 * k * 4 > 48 * 1024:
        raise ValueError(f"map_render: {k} table rows (1..3072 supported)")
    sem, pan, trk = (torch.empty_like(pix) for _ in range(3))
    dep = torch.empty_like(depth_sel)
    KERNEL.launch(pix.data_ptr(), depth_sel.data_ptr(), depth_basic.data_ptr(),
                  *(t.data_ptr() for t in tables), k, num_classes, pix.numel(),
                  sem.data_ptr(), pan.data_ptr(), dep.data_ptr(), trk.data_ptr())
    return sem, pan, dep, trk


render_maps_op = _lib.define_op(
    "render_maps",
    "(Tensor pix, Tensor depth_sel, Tensor depth_basic, Tensor labels, Tensor seg_ids,"
    " Tensor keep, Tensor track_ids, int num_classes) -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=render_maps_plain, cuda=lambda *args: _render_maps_cuda(*args),
    fake=lambda pix, depth_sel, *_: (torch.empty_like(pix), torch.empty_like(pix),
                                     torch.empty_like(depth_sel), torch.empty_like(pix)))


def render_maps(pix: torch.Tensor, depth_sel: torch.Tensor,
                depth_basic: torch.Tensor, labels: torch.Tensor,
                seg_ids: torch.Tensor, keep: torch.Tensor,
                track_ids: torch.Tensor, num_classes: int):
    """pix (H, W) int32 winning candidate; depth_sel/depth_basic (H, W) f32;
    labels/seg_ids/keep/track_ids (K,).  Returns (semantic, panoptic, depth,
    track), all (H, W): a kept winner gives its label, segment id and
    depth_sel; otherwise num_classes, 0 and depth_basic.  track is
    ``track_ids[pix]`` for any winner inside [0, K), else 0 (the caller
    gates it).  A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version.
    """
    return render_maps_op(pix, depth_sel, depth_basic, labels, seg_ids, keep, track_ids,
                          num_classes)
