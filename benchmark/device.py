"""Synchronisation and memory readings that a CPU run (the harness's own
tests, at small sizes) passes over."""
from __future__ import annotations

import torch


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def empty_cache(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
