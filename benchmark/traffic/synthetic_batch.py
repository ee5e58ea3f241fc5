"""Seeded synthetic training batches: a frozen copy of the port's
``data/synthetic.py::synthetic_batch`` (itself the JAX package's
``data/loader.py::synthetic_batch``).  The numpy ``RandomState`` calls are in
the same order, so the same seed gives bit-equal arrays.

A batch is returned as plain tensors, ``(image, gt, ref_image, ref_gt)``
with ``gt`` a dict of the ground-truth fields; each side wraps them in its
own batch structure.
"""
from __future__ import annotations

import numpy as np
import torch

FIELDS = ("thing_masks", "thing_labels", "thing_valid", "thing_inst_ids", "stuff_masks",
          "stuff_valid", "depth", "valid_mask")


def _collate(samples, device) -> dict:
    return {f: torch.from_numpy(np.stack([s[f] for s in samples])).to(device) for f in FIELDS}


def synthetic_batch(model_cfg, batch: int, hw=(256, 512), two_frame: bool = False,
                    seed: int = 0, max_instances: int | None = None, device="cuda"):
    """A random but well-formed batch of ``batch`` images on ``device``.
    ``model_cfg`` needs ``mask_assign_stride``, ``max_things``,
    ``num_stuff_classes`` and ``num_thing_classes``.  max_instances bounds
    the per-image thing count (default: 1-7; ~24 is Cityscapes-like)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    ah, aw = h // model_cfg.mask_assign_stride, w // model_cfg.mask_assign_stride
    mt, ns = model_cfg.max_things, model_cfg.num_stuff_classes

    def one_gt():
        if max_instances is None:
            n = rng.randint(1, min(mt, 8))
        else:
            n = rng.randint(max(max_instances // 2, 1), min(mt, max_instances) + 1)
        cy = rng.randint(0, ah, n)
        cx = rng.randint(0, aw, n)
        r = rng.randint(4, max(ah // 3, 5), n)
        yy, xx = np.mgrid[:ah, :aw]
        masks = np.zeros((mt, ah, aw), np.float32)
        for i in range(n):
            masks[i] = ((np.abs(yy - cy[i]) < r[i]) & (np.abs(xx - cx[i]) < r[i]))
        valid = np.zeros(mt, bool)
        valid[:n] = True
        labels = np.where(valid, rng.randint(0, model_cfg.num_thing_classes, mt), -1)
        inst = np.where(valid, rng.randint(0, 100000, mt), -1)
        stuff = (rng.rand(ns, ah, aw) > 0.85).astype(np.float32)
        sv = rng.rand(ns) > 0.4
        stuff *= sv[:, None, None]
        depth = rng.rand(ah, aw).astype(np.float32) * 60 + 1
        vm = ((masks.sum(0) + stuff.sum(0)) > 0).astype(np.float32)
        return dict(thing_masks=masks, thing_labels=labels.astype(np.int32),
                    thing_valid=valid, thing_inst_ids=inst.astype(np.int32),
                    stuff_masks=stuff, stuff_valid=sv, depth=depth, valid_mask=vm)

    gts = [one_gt() for _ in range(batch)]
    image = torch.from_numpy(rng.randn(batch, h, w, 3).astype(np.float32)).to(device)
    gt = _collate(gts, device)
    if not two_frame:
        return image, gt, None, None
    ref_gt = _collate([one_gt() for _ in range(batch)], device)
    # share the instance ids so track targets have positives
    ref_gt["thing_inst_ids"] = gt["thing_inst_ids"]
    ref_image = torch.from_numpy(rng.randn(batch, h, w, 3).astype(np.float32)).to(device)
    return image, gt, ref_image, ref_gt


def pool(mix: dict, model_cfg, batch: int, hw, seed: int, device):
    """The mix's pool of ``mix['pool']`` batches, batch i drawn from seed
    ``(seed * pool + i) mod 2**32`` (numpy seeds are 32 bits)."""
    n = int(mix["pool"])
    return [synthetic_batch(model_cfg, batch, hw, two_frame=bool(mix["two_frame"]),
                            seed=(seed * n + i) % 2 ** 32,
                            max_instances=mix.get("max_instances"), device=device)
            for i in range(n)]
