"""Seeded synthetic DVPS splits on disk, written with the port's PNG encoder
(``data/png.py``), in the two layouts the dataset scanner reads
(``video_sequence/<split>/``):

* Cityscapes-DVPS (:func:`write_dvps_split`, the layout of the JAX tests'
  ``write_synthetic_dataset``): for each frame ``{seq:06d}_{t:06d}_loc_000019_000000_``
  + ``leftImg8bit.png`` (RGB), ``gtFine_instanceTrainIds.png`` (uint16
  trainId * 1000 + instance) and ``depth.png`` (uint16 meters * 256);
* SemKITTI-DVPS (:func:`write_semkitti_split`, the layout of the JAX
  ``tests/test_semkitti_e2e.py``): ``{seq:06d}_{t:06d}_`` +
  ``leftImg8bit.png``, ``gtFine_class.png`` (uint8 trainIds, 255 void),
  ``gtFine_instance.png`` (uint16 in-class instance id, 0 for stuff) and
  ``depth_718.8560180664062.png`` (the focal length in the name).

The panoptic map is road below and sky above, car and person rectangles
that keep their instance ids and move a few pixels each frame, and a
no-object patch in the bottom-right corner.  The image paints each segment
in its own colour over blocks of colour noise, so a model sees structure
that persists from frame to frame; the depth falls from 80 m at the horizon
to the bottom row, things stand nearer.
"""
from __future__ import annotations

import os

import numpy as np

from .png import write_png

ROAD, SKY, PERSON, CAR, NO_OBJ = 0, 10, 11, 13, 32
SEMKITTI_FOCAL = "718.8560180664062"


def _frames(rng, num_seqs: int, frames_per_seq: int, h: int, w: int, things):
    """(seq, t, image, panoptic trainId * 1000 + instance, depth) of each
    frame; ``things`` is the [low, high) range of the things a sequence."""
    block = max(h // 16, 1)
    yy = np.arange(h, dtype=np.float32)[:, None]
    for seq in range(num_seqs):
        n = rng.randint(*things)
        cls = np.where(rng.rand(n) < 0.5, CAR, PERSON)
        th = rng.randint(h // 12, h // 5, n)
        tw = np.where(cls == CAR, 2 * th, th // 2 + 1)
        y0 = rng.randint(h // 3, h - th)
        x0 = rng.randint(0, w - tw)
        vy = rng.randint(-2, 3, n)
        vx = rng.randint(-6, 7, n)
        colours = rng.randint(0, 256, (n + 2, 3))
        noise = rng.randint(0, 256, (h // block + 1, w // block + 1, 3))
        background = np.repeat(np.repeat(noise, block, 0), block, 1)[:h, :w]
        for t in range(frames_per_seq):
            pan = np.full((h, w), ROAD * 1000, np.int64)
            pan[: h // 3] = SKY * 1000
            img = (background // 2 + np.where(pan[..., None] == ROAD * 1000, colours[0],
                                              colours[1]) // 2)
            near = np.zeros((h, w), np.float32)
            for i in range(n):
                ys = int(np.clip(y0[i] + vy[i] * t, 0, h - th[i]))
                xs = int(np.clip(x0[i] + vx[i] * t, 0, w - tw[i]))
                pan[ys:ys + th[i], xs:xs + tw[i]] = cls[i] * 1000 + i + 1
                img[ys:ys + th[i], xs:xs + tw[i]] = colours[i + 2]
                near[ys:ys + th[i], xs:xs + tw[i]] = 0.3
            pan[-(h // 16 + 1):, -(w // 16 + 1):] = NO_OBJ * 1000
            img = np.clip(img + rng.randint(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)
            depth = np.clip(80.0 - 75.0 * (yy / h), 1.0, 80.0) * (1.0 - near)
            depth = depth * (1.0 + 0.05 * rng.rand(h, w).astype(np.float32))
            yield seq, t, img, pan, np.clip(depth * 256, 0, 65535).astype(np.uint16)


def write_dvps_split(root: str, split: str = "val", num_seqs: int = 2,
                     frames_per_seq: int = 3, h: int = 128, w: int = 256,
                     seed: int = 0, filter_type: int = 0) -> list:
    """Write a Cityscapes-DVPS split of 12-24 things a sequence, every PNG
    row filtered by ``filter_type`` (4, Paeth, is what encoders pick for
    most rows of a photograph); returns the frame stems in order."""
    d = os.path.join(root, "video_sequence", split)
    os.makedirs(d, exist_ok=True)
    stems = []
    for seq, t, img, pan, depth in _frames(np.random.RandomState(seed), num_seqs,
                                           frames_per_seq, h, w, (12, 25)):
        stem = f"{seq:06d}_{t:06d}_loc_000019_000000"
        write_png(os.path.join(d, f"{stem}_leftImg8bit.png"), img, filter_type=filter_type)
        write_png(os.path.join(d, f"{stem}_gtFine_instanceTrainIds.png"),
                  pan.astype(np.uint16), filter_type=filter_type)
        write_png(os.path.join(d, f"{stem}_depth.png"), depth, filter_type=filter_type)
        stems.append(stem)
    return stems


def write_semkitti_split(root: str, split: str = "val", num_seqs: int = 2,
                         frames_per_seq: int = 3, h: int = 376, w: int = 1241,
                         seed: int = 0, filter_type: int = 0) -> list:
    """Write a SemKITTI-DVPS split (the real frames are 376x1241) of 18-22
    things a sequence, SemKITTI's density; returns the frame stems in
    order."""
    d = os.path.join(root, "video_sequence", split)
    os.makedirs(d, exist_ok=True)
    stems = []
    for seq, t, img, pan, depth in _frames(np.random.RandomState(seed), num_seqs,
                                           frames_per_seq, h, w, (18, 23)):
        stem = f"{seq:06d}_{t:06d}"
        cls = pan // 1000
        inst = np.where(cls >= PERSON, pan % 1000, 0)
        cls = np.where(cls == NO_OBJ, 255, cls)
        write_png(os.path.join(d, f"{stem}_leftImg8bit.png"), img, filter_type=filter_type)
        write_png(os.path.join(d, f"{stem}_gtFine_class.png"), cls.astype(np.uint8),
                  filter_type=filter_type)
        write_png(os.path.join(d, f"{stem}_gtFine_instance.png"), inst.astype(np.uint16),
                  filter_type=filter_type)
        write_png(os.path.join(d, f"{stem}_depth_{SEMKITTI_FOCAL}.png"), depth,
                  filter_type=filter_type)
        stems.append(stem)
    return stems
