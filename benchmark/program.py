"""The program under test as the benchmark builds it: the port's experiment
configuration from a configuration file, and the port's batch structures.
Only the entries (``benchmark/entries``) import this module."""
from __future__ import annotations

import dataclasses

import torch


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = tuple(v) if isinstance(v, list) else v
    return out


def experiment(config: dict):
    """The port's ``ExperimentConfig`` of a configuration file: its preset
    with every field the file states differently set to the file's value.
    Raises if a field of the file is unknown to the port."""
    from polyphonicformer_torch.configs import apply_overrides, preset

    cfg = preset(config["preset"])
    have = _flat(dataclasses.asdict(cfg))
    want = _flat(config["experiment"])
    unknown = set(want) - set(have)
    if unknown:
        raise KeyError(f"fields the program does not have: {sorted(unknown)}")
    changes = {k: v for k, v in want.items() if have[k] != v}
    if changes:
        cfg = apply_overrides(cfg, changes)
    return cfg


def train_batch(parts):
    """(image, gt, ref_image, ref_gt) of the traffic's generator -> the
    port's ``TrainBatch``."""
    from polyphonicformer_torch.data.structures import GTSample, TrainBatch

    image, gt, ref_image, ref_gt = parts
    return TrainBatch(image=image, gt=GTSample(**gt), ref_image=ref_image,
                      ref_gt=None if ref_gt is None else GTSample(**ref_gt))


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
