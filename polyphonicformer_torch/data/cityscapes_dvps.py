"""Cityscapes-DVPS dataset: filesystem scan, sequence sampling, PNG decode;
a copy of ``polyphonicformer_tpu/data/cityscapes_dvps.py`` whose image reads
go through ``data/png.py`` instead of cv2.

reference: datasets/cityscapes_dvps.py (filename triplets
``{seq}_{img}_{location}_..._leftImg8bit.png`` with ``gtFine_instanceTrainIds``
panoptic PNG and ``depth`` PNG; class remap thing-first via to_coco;
ref-frame sampling modes random/img).
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .png import imread_rgb, imread_unchanged

# thing-first class order (reference datasets/cityscapes_dvps.py:20-57)
CLASSES = (
    "road", "sidewalk", "building", "wall", "fence",
    "pole", "traffic light", "traffic sign", "vegetation", "terrain",
    "sky", "person", "rider", "car", "truck",
    "bus", "train", "motorcycle", "bicycle",
)
THING_CLASSES = ("person", "rider", "car", "truck",
                 "bus", "train", "motorcycle", "bicycle")
STUFF_CLASSES = ("road", "sidewalk", "building", "wall", "fence",
                 "pole", "traffic light", "traffic sign", "vegetation",
                 "terrain", "sky")
NUM_THING = len(THING_CLASSES)
NUM_STUFF = len(STUFF_CLASSES)
NO_OBJ = 32
NO_OBJ_HB = 255
DIVISOR_PAN = 1000
INSTANCE_DIVISOR = 10000

# trainId -> thing-first id remap
_THING_MAP = {CLASSES.index(c): i for i, c in enumerate(THING_CLASSES)}
_STUFF_MAP = {CLASSES.index(c): i + NUM_THING for i, c in enumerate(STUFF_CLASSES)}
TRAINID_TO_COCO = {**_THING_MAP, **_STUFF_MAP}


def to_coco(pan_map: np.ndarray, divisor: int) -> np.ndarray:
    """Remap trainId*1000+inst panoptic ids to thing-first ids * divisor + inst
    (reference datasets/cityscapes_dvps.py:89-109).  ``pan_map`` must be
    signed (callers pass int64): the -1 sentinel of unmapped ids would wrap
    in an unsigned map.

    One-gather lookup-table form of the reference's per-unique-id scan loop
    (id values are bounded by NO_OBJ*1000+inst, so the table stays tiny
    next to the 2M-pixel map it replaces ~2 full-image scans per id with).
    """
    n = int(pan_map.max()) + 1
    ids = np.arange(n, dtype=pan_map.dtype)
    cls = ids // DIVISOR_PAN
    inst = ids % DIVISOR_PAN
    coco = np.array([TRAINID_TO_COCO.get(int(c), -1) for c in
                     np.arange(int(cls.max()) + 1)], dtype=pan_map.dtype)
    lut = np.where(coco[cls] < 0, -1, coco[cls] * divisor + inst)
    if NO_OBJ * DIVISOR_PAN < n:
        lut[NO_OBJ * DIVISOR_PAN] = NO_OBJ_HB * divisor
    pan_new = lut[pan_map]
    if not (pan_new >= 0).all():
        raise ValueError("unmapped panoptic id")
    return pan_new


def load_depth(path: str, max_depth: float = 80.0) -> np.ndarray:
    """16-bit depth PNG / 256 -> meters, clamped (loading.py:170-175)."""
    depth = imread_unchanged(path).astype(np.float32) / 256.0
    depth[depth >= max_depth] = max_depth
    return depth


def load_panoptic(path: str, divisor: int = INSTANCE_DIVISOR) -> np.ndarray:
    """instanceTrainIds PNG -> thing-first panoptic id map."""
    ps = imread_unchanged(path).astype(np.int64)
    return to_coco(ps, divisor)


def load_panoptic_pair(cls_path: str, inst_path: str,
                       divisor: int = INSTANCE_DIVISOR) -> np.ndarray:
    """SemKITTI-DVPS split GT (gtFine_class trainId PNG + gtFine_instance
    in-class id PNG) -> the combined trainId*1000+inst convention, then the
    same thing-first remap as Cityscapes."""
    cls = imread_unchanged(cls_path).astype(np.int64)
    inst = imread_unchanged(inst_path).astype(np.int64)
    cls = np.where(cls == 255, NO_OBJ, cls)  # void -> no-obj
    combined = cls * DIVISOR_PAN + np.where(cls == NO_OBJ, 0, inst)
    return to_coco(combined, divisor)


def decode_segments(pan: np.ndarray, divisor: int = INSTANCE_DIVISOR):
    """Panoptic id map -> per-segment binary masks/labels/instance ids,
    dropping the no-obj class (loading.py:196-254)."""
    ids = np.unique(pan)
    masks, labels, inst_ids = [], [], []
    for pid in ids:
        cls = int(pid) // divisor
        if cls == NO_OBJ_HB:
            continue
        masks.append((pan == pid).astype(np.uint8))
        labels.append(cls)
        inst_ids.append(int(pid))
    if not masks:
        return (np.zeros((0,) + pan.shape, np.uint8),
                np.zeros((0,), np.int64), np.zeros((0,), np.int64))
    return np.stack(masks), np.asarray(labels), np.asarray(inst_ids)


class CityscapesDVPSDataset:
    """Sequence-aware index over the video_sequence directory layout."""

    def __init__(self, data_root: str, split: str = "train",
                 ref_sample_mode: str = "img",
                 ref_seq_index: Sequence[int] = (),
                 with_depth: bool = True,
                 test_mode: bool = False,
                 ref_seq_len_test: int = 1):
        self.data_root = os.path.expanduser(data_root)
        seq_dir = os.path.join(self.data_root, "video_sequence", split)
        if not os.path.exists(seq_dir):
            raise FileNotFoundError(seq_dir)
        self.seq_dir = seq_dir
        self.split = split
        self.ref_sample_mode = ref_sample_mode
        self.ref_seq_index = list(ref_seq_index)
        self.with_depth = with_depth
        self.test_mode = test_mode

        all_files = sorted(os.listdir(seq_dir))
        file_set = set(all_files)
        names = [f for f in all_files if "leftImg8bit" in f]
        images: List[Dict] = []
        for name in names:
            # Cityscapes-DVPS: {seq}_{img}_{location}_..._leftImg8bit.png
            # (reference datasets/cityscapes_dvps.py:152, 6 '_'-fields);
            # SemKITTI-DVPS:   {seq:06d}_{frame:06d}_leftImg8bit.png
            parts = name.split("_")
            seq_id, img_id = parts[0], parts[1]
            location = parts[2] if len(parts) > 3 else ""
            full = os.path.join(seq_dir, name)
            depth = None
            if with_depth:
                depth = full.replace("leftImg8bit", "depth")
                if os.path.basename(depth) not in file_set:
                    # SemKITTI depth PNGs carry the focal length:
                    # {seq}_{frame}_depth_{focal}.png
                    prefix = f"{seq_id}_{img_id}_depth"
                    cand = [f for f in all_files
                            if f.startswith(prefix) and f.endswith(".png")]
                    if not cand:
                        raise FileNotFoundError(f"no depth file for {name}")
                    depth = os.path.join(seq_dir, cand[0])
            ann = full.replace("leftImg8bit", "gtFine_instanceTrainIds")
            ann_inst = None
            if os.path.basename(ann) not in file_set:
                # SemKITTI-DVPS splits GT into class + in-class instance PNGs
                cls_ann = full.replace("leftImg8bit", "gtFine_class")
                inst_ann = full.replace("leftImg8bit", "gtFine_instance")
                if os.path.basename(cls_ann) in file_set:
                    ann, ann_inst = cls_ann, inst_ann
            images.append(dict(
                seq_id=int(seq_id),
                img_id=int(img_id),
                location=location,
                img=full,
                depth=depth,
                ann=ann,
                ann_inst=ann_inst,
            ))
        self.by_key = {(im["seq_id"], im["img_id"]): im for im in images}
        self.images = images

        if ref_sample_mode == "img":
            self.samples = [[im] for im in images]
        elif ref_sample_mode == "random":
            # key frame + one random ref offset resolved at fetch time
            self.samples = [[im] for im in images]
        elif ref_sample_mode == "sequence":
            # all ref offsets must exist; clip ordered [key, refs...] with the
            # most-negative offset first after the key frame (reference
            # datasets/cityscapes_dvps.py:192-212: offsets reversed, then the
            # whole list reversed so the key frame leads)
            self.samples = []
            for im in images:
                clip = []
                ok = True
                for off in reversed(self.ref_seq_index):
                    ref = self.by_key.get((im["seq_id"], im["img_id"] + off))
                    if ref is None:
                        ok = False
                        break
                    clip.append(ref)
                if ok:
                    clip.append(im)
                    clip.reverse()
                    self.samples.append(clip)
        elif ref_sample_mode == "test":
            # fixed-length chunks per sequence; the first frame of each chunk
            # is duplicated as its own reference, and the final short chunk is
            # right-padded by repeating its last frame (reference
            # datasets/cityscapes_dvps.py:213-238)
            n = ref_seq_len_test
            if n == 0:
                self.samples = [[im] for im in images]
            elif n == 1:
                self.samples = [[im, im] for im in images]
            else:
                self.samples = []
                seq_id_pre, seq_now = -1, []
                for im in images:
                    if im["seq_id"] != seq_id_pre:
                        seq_id_pre = im["seq_id"]
                        if seq_now:
                            while len(seq_now) < n + 1:
                                seq_now.append(seq_now[-1])
                            self.samples.append(seq_now)
                        seq_now = [im, im]
                    elif len(seq_now) % (n + 1) == 0:
                        self.samples.append(seq_now)
                        seq_now = [im, im]
                    else:
                        seq_now.append(im)
                # NOTE the reference drops the trailing chunk here (its loop
                # never flushes after the last image); replicated faithfully
        else:
            raise ValueError(ref_sample_mode)

    def __len__(self) -> int:
        return len(self.samples)

    def get_pair(self, idx: int, rng: Optional[random.Random] = None):
        """Key frame + one ref frame (train 'random' mode). Returns None if
        no valid ref exists (caller resamples)."""
        rng = rng or random
        key = self.samples[idx][0]
        if not self.ref_seq_index:
            return key, None
        offset = rng.choice(self.ref_seq_index)
        ref = self.by_key.get((key["seq_id"], key["img_id"] + offset))
        if ref is None:
            return None
        return key, ref

    def load_frame(self, info: Dict, segments: bool = True):
        """Decode one frame's image + GT arrays.  ``segments=False`` skips
        the per-segment mask decode (eval only needs the raw id map)."""
        img = imread_rgb(info["img"])
        if info.get("ann_inst"):
            pan = load_panoptic_pair(info["ann"], info["ann_inst"])
        else:
            pan = load_panoptic(info["ann"])
        depth = load_depth(info["depth"]) if self.with_depth else None
        out = dict(img=img, pan=pan, depth=depth,
                   seq_id=info["seq_id"], img_id=info["img_id"])
        if segments:
            masks, labels, inst_ids = decode_segments(pan)
            out.update(masks=masks, labels=labels, inst_ids=inst_ids)
        return out
