"""Seeded tracker inputs for the tests of ``poly::tracker_step`` (K9): a
configuration and a sequence of frames of B clips, made with numpy on the
CPU.

The seed picks the match metric (``seed % 3``), ``with_cats``
(``seed // 3 % 2``) and how many rows are valid a frame (``seed // 6 % 4``:
none, 4, all D, or any number).  Each clip draws detections from a pool of
objects, each with its own embedding, label and moving box, so detections
match tracklets of earlier frames; all D rows valid draw from a pool large
enough that the table of T tracklets fills and overflows.  Into each frame
go: scores tied with each other and equal to the thresholds, boxes copied
exactly from another row (intra-frame duplicates), embeddings copied
exactly from another row (tracklets whose scores tie: the lowest column
must win), invalid rows between valid ones with garbage in them, and gaps
in the frame ids beyond ``memo_tracklet_frames`` (expiry).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from polyphonicformer_torch.configs import TrackerConfig
from polyphonicformer_torch.infer.tracker import init_tracker_state

METRICS = ("bisoftmax", "softmax", "cosine")
TIED_SCORES = np.float32([0.3, 0.35, 0.5, 0.9, 0.9, 0.31])


def config(seed: int, d: int = 64, t: int = 128, bd: int = 64) -> TrackerConfig:
    return TrackerConfig(match_metric=METRICS[seed % 3], with_cats=bool(seed // 3 % 2),
                         max_tracklets=t, max_detections=d, memo_backdrop_frames=bd // d)


def sequence(seed: int, b: int, frames: int = 8, d: int = 64, t: int = 128, bd: int = 64,
             e: int = 256):
    """(cfg, [(bboxes (B, D, 5), labels (B, D), embeds (B, D, E),
    det_valid (B, D), frame_ids (B,))] * frames), CPU tensors."""
    cfg = config(seed, d, t, bd)
    rng = np.random.RandomState(seed)
    full = seed // 6 % 4 == 2
    pool = 8 * t if full else max(2 * d, 8)
    scale = (0.05, 0.2, 1.0)[seed // 24 % 3]
    base_emb = (rng.randn(b, pool, e) * scale).astype(np.float32)
    base_xy = rng.rand(b, pool, 2) * 900
    wh = rng.rand(b, pool, 2) * 80 + 10
    vel = rng.randn(b, pool, 2) * 5
    base_lab = rng.randint(0, 3, (b, pool))
    fid = rng.randint(0, 50, b)
    out = []
    for f in range(frames):
        boxes = (rng.rand(b, d, 5) * 500).astype(np.float32)  # garbage in invalid rows
        labels = rng.randint(-5, 9, (b, d)).astype(np.int32)
        emb = rng.randn(b, d, e).astype(np.float32)
        valid = np.zeros((b, d), bool)
        for c in range(b):
            n = (0, min(4, d), d, int(rng.randint(0, d + 1)))[seed // 6 % 4]
            rows = np.sort(rng.choice(d, n, replace=False))
            objs = rng.choice(pool, n, replace=False)
            xy = base_xy[c, objs] + vel[c, objs] * f + rng.randn(n, 2)
            boxes[c, rows, :2] = xy
            boxes[c, rows, 2:4] = xy + wh[c, objs]
            score = rng.rand(n).astype(np.float32)
            tied = rng.rand(n) < 0.3
            score[tied] = rng.choice(TIED_SCORES, int(tied.sum()))
            boxes[c, rows, 4] = score
            labels[c, rows] = base_lab[c, objs]
            emb[c, rows] = base_emb[c, objs] + rng.randn(n, e).astype(np.float32) * scale * 0.2
            valid[c, rows] = True
            if n >= 2:
                i, j = rng.choice(rows, 2, replace=False)
                if rng.rand() < 0.5:  # an exact duplicate box, another score
                    boxes[c, j, :4] = boxes[c, i, :4]
                if rng.rand() < 0.5:  # an exact duplicate embedding
                    emb[c, j] = emb[c, i]
        fid = fid + rng.choice([1, 1, 1, 2, cfg.memo_tracklet_frames + 1], b)
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                         (boxes, labels, emb, valid, fid.astype(np.int32))))
    return cfg, out


def fresh_states(cfg: TrackerConfig, b: int, e: int, device="cpu"):
    """``b`` fresh tracker states stacked on a leading clip axis."""
    one = init_tracker_state(cfg, e, device)
    return one.map(lambda x: torch.stack([x] * b))


def state_fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
