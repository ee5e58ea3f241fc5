"""Checkpoints with the reference's keep-last-2 and resume semantics;
mirrors ``polyphonicformer_tpu/train/checkpoint.py`` without orbax.

reference: mmcv CheckpointHook (interval 1 epoch, max_keep_ckpts=2,
configs/_base_/default_runtime.py:1) and the --auto-resume scan for the
latest checkpoint (mmdet/apis/train.py:206-214).

A checkpoint is ``work_dir/checkpoints/<step>.pt``: one ``torch.save`` of
the model's ``state_dict``, the optimizer's (AdamW moments and step
counts, the ``LambdaLR`` position) and the step.  It is written under a
temporary name and renamed into place, so a save that is killed leaves no
file that a resume would pick up.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    path: str
    max_keep: int = 2

    def steps(self) -> List[int]:
        """The saved steps, ascending (temporary files left out)."""
        found = (_NAME.match(n) for n in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in found if m)

    def file(self, step: int) -> str:
        return os.path.join(self.path, f"{step}.pt")


def make_manager(work_dir: str, max_keep: int = 2) -> CheckpointManager:
    path = os.path.abspath(os.path.join(work_dir, "checkpoints"))
    os.makedirs(path, exist_ok=True)
    return CheckpointManager(path, max_keep)


def save_state(mgr: CheckpointManager, step: int, state, optimizer) -> str:
    """Save ``state`` (a ``TrainState``) and ``optimizer`` as checkpoint
    ``step``; keep the newest ``max_keep``.  Returns the file."""
    out = mgr.file(step)
    tmp = os.path.join(mgr.path, f".{step}.pt.{os.getpid()}.tmp")
    torch.save({"step": int(step), "model": state.model.state_dict(),
                "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, out)
    for old in mgr.steps()[:-mgr.max_keep]:
        os.remove(mgr.file(old))
    return out


def latest_step(mgr: CheckpointManager) -> Optional[int]:
    steps = mgr.steps()
    return steps[-1] if steps else None


def restore_state(mgr: CheckpointManager, state, optimizer, step: Optional[int] = None):
    """Load checkpoint ``step`` (default: the latest) into ``state.model``
    and ``optimizer`` on the model's device; returns the state with the
    saved step."""
    step = step if step is not None else latest_step(mgr)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {mgr.path}")
    dev = next(state.model.parameters()).device
    ckpt = torch.load(mgr.file(step), map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    return dataclasses.replace(
        state, step=torch.full_like(state.step, ckpt["step"]))
