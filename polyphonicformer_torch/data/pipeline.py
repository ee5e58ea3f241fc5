"""Host-side preprocessing; mirrors ``polyphonicformer_tpu/data/pipeline.py``.

Train half (reference configs/_base_/datasets/cityscapes_dvps.py:8-21):
SeqResizeWithDepth (ratio 1.0-2.0 of 1024x2048, keep_ratio; depth divided
by the scale factor, transforms.py:32), SeqFlipWithDepth (p=0.5, shared
across the clip), SeqRandomCropWithDepth (1024x2048 shared crop; a clip is
rejected when no thing instance survives in both frames,
transforms.py:300-310), SeqNormalizeWithDepth + SeqPadWithDepth (divisor
32), and the GT preparation the reference does on the GPU each step
(polyphonic_former.py:60-94): pad and bilinear-downsample the masks to
stride 4 (nearest in the SemKITTI-DVPS mode, ``semantic_kitti``),
nearest-downsample depth, split thing and stuff.  cv2's resizes
are emulated bit for bit by :mod:`.resize`; the ``random.Random`` draws are
the JAX pipeline's, in its order.

A divisor-aligned crop ships its image as the raw uint8 crop at its true
size; the loader normalises it on the device and pads it with 0 after the
normalisation, as mmdet pads after Normalize.  (The JAX pipeline pads the
raw uint8 crop with 0 before the normalisation, so where an image was
smaller than the crop its pad is ``-mean / std`` instead of 0: fault F2.)

Test half: ``normalize_image``, ``pad_to``, ``make_test_input``.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .resize import downsample_linear_x4, resize_linear_u8, resize_nearest


def resize_frame(frame: Dict, ratio: float, max_depth: float = 80.0) -> Dict:
    h, w = frame["img"].shape[:2]
    nh, nw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    out = dict(frame)
    out["img"] = resize_linear_u8(frame["img"], nh, nw)
    if frame["masks"].shape[0] > 0:
        out["masks"] = resize_nearest(frame["masks"], nh, nw)
    else:
        out["masks"] = np.zeros((0, nh, nw), np.uint8)
    if frame.get("depth") is not None:
        # depth scales inversely with image scale (transforms.py:32)
        out["depth"] = resize_nearest(frame["depth"], nh, nw) / ratio
    return out


def flip_frame(frame: Dict) -> Dict:
    """Horizontal flip as negative-stride views (every consumer copies)."""
    out = dict(frame)
    out["img"] = frame["img"][:, ::-1]
    out["masks"] = frame["masks"][:, :, ::-1]
    if frame.get("depth") is not None:
        out["depth"] = frame["depth"][:, ::-1]
    return out


def crop_frame(frame: Dict, y0: int, x0: int, ch: int, cw: int) -> Optional[Dict]:
    """Crop; drop empty instances; None if no instance survives
    (the reference rejects via empty gt_bboxes, transforms.py:244-248)."""
    out = dict(frame)
    out["img"] = frame["img"][y0:y0 + ch, x0:x0 + cw]
    masks = frame["masks"][:, y0:y0 + ch, x0:x0 + cw]
    keep = masks.any(axis=(1, 2))
    if not keep.any():
        return None
    out["masks"] = masks[keep]
    out["labels"] = frame["labels"][keep]
    out["inst_ids"] = frame["inst_ids"][keep]
    if frame.get("depth") is not None:
        out["depth"] = frame["depth"][y0:y0 + ch, x0:x0 + cw]
    return out


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    out = np.subtract(img, np.asarray(mean, np.float32), dtype=np.float32)
    out /= np.asarray(std, np.float32)
    return out


def pad_to(img: np.ndarray, ph: int, pw: int, value=0) -> np.ndarray:
    h, w = img.shape[:2]
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, constant_values=value)


def _downsample_mask_bilinear(mask: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2 ``INTER_LINEAR`` of the f32 mask to stride 4 (the reference's
    align_corners=False bilinear of its GT masks)."""
    return downsample_linear_x4(mask, oh, ow)


def _downsample_nearest_torch(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """torch mode='nearest' (asymmetric floor) downsample."""
    h, w = x.shape[:2]
    iy = np.clip(np.floor(np.arange(oh) * (h / oh)).astype(np.int64), 0, h - 1)
    ix = np.clip(np.floor(np.arange(ow) * (w / ow)).astype(np.int64), 0, w - 1)
    return x[iy][:, ix]


def frame_to_sample(frame: Dict, model_cfg, pad_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Pad and downsample the GT to stride 4, split thing and stuff, pad to
    static shapes: the fields of ``data.structures.GTSample`` plus
    ``image``.  A float image is padded with 0 to ``pad_hw``; a uint8 image
    (not yet normalised) keeps its size, and the loader pads it after the
    normalisation."""
    ph, pw = pad_hw
    stride = model_cfg.mask_assign_stride
    ah, aw = ph // stride, pw // stride
    mt = model_cfg.max_things
    ns = model_cfg.num_stuff_classes
    nt = model_cfg.num_thing_classes

    img = frame["img"]
    img = np.ascontiguousarray(img) if img.dtype == np.uint8 else pad_to(img, ph, pw)

    labels = frame["labels"]
    masks = frame["masks"]
    small = np.zeros((len(masks), ah, aw), np.float32)
    for i, m in enumerate(masks):
        padded = pad_to(m, ph, pw)
        if model_cfg.semantic_kitti:
            # SemKITTI mode: nearest GT downsample (polyphonic_former.py:77-80)
            small[i] = _downsample_nearest_torch(padded.astype(np.float32), ah, aw)
        else:
            small[i] = _downsample_mask_bilinear(padded, ah, aw)

    is_thing = labels < nt
    thing_small = small[is_thing]
    thing_labels = labels[is_thing]
    thing_ids = frame["inst_ids"][is_thing]
    if len(thing_small) > mt:
        # capacity overflow: keep the largest instances
        areas = thing_small.sum(axis=(1, 2))
        order = np.argsort(-areas)[:mt]
        thing_small, thing_labels, thing_ids = (
            thing_small[order], thing_labels[order], thing_ids[order])

    n = len(thing_small)
    thing_masks = np.zeros((mt, ah, aw), np.float32)
    thing_masks[:n] = thing_small
    tl = np.full((mt,), -1, np.int32)
    tl[:n] = thing_labels
    ti = np.full((mt,), -1, np.int32)
    ti[:n] = thing_ids
    tv = np.zeros((mt,), bool)
    tv[:n] = True

    stuff_masks = np.zeros((ns, ah, aw), np.float32)
    stuff_valid = np.zeros((ns,), bool)
    for m, lab in zip(small[~is_thing], labels[~is_thing]):
        slot = int(lab) - nt
        stuff_masks[slot] = m
        stuff_valid[slot] = True

    depth = np.zeros((ah, aw), np.float32)
    if frame.get("depth") is not None:
        depth = _downsample_nearest_torch(pad_to(frame["depth"], ph, pw), ah, aw)

    valid = (thing_masks.sum(0) + stuff_masks.sum(0)) > 0

    return dict(
        image=img,
        thing_masks=thing_masks,
        thing_labels=tl,
        thing_valid=tv,
        thing_inst_ids=ti,
        stuff_masks=stuff_masks,
        stuff_valid=stuff_valid,
        depth=depth,
        valid_mask=valid.astype(np.float32),
    )


class TrainPipeline:
    """Train-time augmentation of a 1- or 2-frame clip; picklable (the
    loaders' spawn workers build their own)."""

    def __init__(self, data_cfg, model_cfg):
        self.dc = data_cfg
        self.mc = model_cfg

    def __call__(self, frames: List[Dict], rng: random.Random
                 ) -> Optional[List[Dict[str, np.ndarray]]]:
        dc = self.dc
        ratio = rng.uniform(*dc.ratio_range)
        frames = [resize_frame(f, ratio, dc.max_depth) for f in frames]
        if rng.random() < dc.flip_ratio:
            frames = [flip_frame(f) for f in frames]
        ch, cw = dc.img_size
        h, w = frames[0]["img"].shape[:2]
        y0 = rng.randint(0, max(h - ch, 0))
        x0 = rng.randint(0, max(w - cw, 0))
        cropped = []
        for f in frames:
            c = crop_frame(f, y0, x0, ch, cw)
            if c is None:
                return None
            cropped.append(c)
        frames = cropped
        # reject the clip when no thing instance is shared (check_id_match)
        if len(frames) == 2:
            key_things, ref_things = (
                {i for i in f["inst_ids"][f["labels"] < self.mc.num_thing_classes].tolist()
                 if i < dc.check_id_match} for f in frames)
            if not (key_things & ref_things):
                return None
        ph, pw = padded_hw(dc)
        out = []
        for f in frames:
            if (ph, pw) != (ch, cw):
                # a crop size off the divisor: normalise here, pad with 0 after
                f = dict(f, img=normalize_image(f["img"], dc.mean, dc.std))
            out.append(frame_to_sample(f, self.mc, (ph, pw)))
        return out


def padded_hw(data_cfg) -> Tuple[int, int]:
    """The crop size rounded up to the size divisor: every train image's
    shape after padding."""
    (h, w), div = data_cfg.img_size, data_cfg.size_divisor
    return (h + div - 1) // div * div, (w + div - 1) // div * div


def make_test_input(frame: Dict, data_cfg) -> Dict:
    """Normalize, then pad with 0 to the size divisor (reference
    configs/_base_/datasets/cityscapes_dvps.py:23-41: Normalize before Pad,
    so the pad is 0 in normalized space)."""
    img = normalize_image(frame["img"], data_cfg.mean, data_cfg.std)
    h, w = img.shape[:2]
    div = data_cfg.size_divisor
    ph = (h + div - 1) // div * div
    pw = (w + div - 1) // div * div
    return dict(image=pad_to(img, ph, pw), ori_hw=(h, w),
                seq_id=frame["seq_id"], img_id=frame["img_id"])
