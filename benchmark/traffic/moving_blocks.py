"""Camera-like frames made on the card from the seed: per stream a field of
colour blocks (cells of ``cell_px`` pixels, values ~ N(0, block_std^2),
already normalized and padded to the image size) that moves along a closed
path of ``motion_px`` pixels' radius over ``cycle_frames`` frames, plus fresh
noise of ``noise`` std a frame.  Frame t of a stream is frame ``t mod
cycle_frames`` of its cycle, so the pool repeats without a jump.  Returns
(cycle_frames, streams, H, W, 3) f32: step t takes ``pool[t % cycle]``, one
frame of every stream.
"""
from __future__ import annotations

import math

import torch


def pool(mix: dict, hw, seed: int, device) -> torch.Tensor:
    h, w = hw
    streams, cycle, cell = int(mix["streams"]), int(mix["cycle_frames"]), int(mix["cell_px"])
    radius = float(mix["motion_px"])
    gen = torch.Generator(device=device).manual_seed(seed)
    ch, cw = -(-h // cell) + 2, -(-w // cell) + 2
    blocks = torch.randn((streams, ch, cw, 3), generator=gen, device=device) * mix["block_std"]
    field = blocks.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    noise = torch.randn((cycle, streams, h, w, 3), generator=gen, device=device) * mix["noise"]
    out = torch.empty((cycle, streams, h, w, 3), device=device)
    for t in range(cycle):
        angle = 2.0 * math.pi * t / cycle
        dy = cell + int(round(radius * math.sin(angle)))
        dx = cell + int(round(radius * math.cos(angle)))
        out[t] = field[:, dy:dy + h, dx:dx + w] + noise[t]
    return out
