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

Under tensor parallelism (a ``mesh`` with a model axis) the ranks gather
their shards of the model and of AdamW's moments to rank 0, which writes
the one-card format (``weights.gather_state_dict``); a restore cuts the
full file into the rank's shards again (``weights.shard_state_dict``).
Under data parallelism alone every rank holds the same state, and rank 0
saves it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from typing import Dict, List, Optional

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


def state_digest(state_dict: Dict[str, torch.Tensor]) -> str:
    """sha256 over a state dict's keys, dtypes, shapes and bytes: equal for
    equal states, on any device."""
    h = hashlib.sha256()
    for k in sorted(state_dict):
        t = state_dict[k].detach().cpu().contiguous()
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _param_names(optimizer) -> List[str]:
    """The parameter names in the order of ``torch.optim``'s state-dict
    keys (positions over the parameter groups)."""
    return [optimizer.names[id(p)] for g in optimizer.adamw.param_groups for p in g["params"]]


def _full_state(state, optimizer, mesh):
    """(model state dict, optimizer state dict) of the full model: the
    rank's own without a model axis, else the model group's shards
    gathered (every rank of the group calls it)."""
    model_sd, opt_sd = state.model.state_dict(), optimizer.state_dict()
    if mesh is None or mesh.num_model == 1:
        return model_sd, opt_sd
    import torch.distributed as dist

    from ..weights import gather_state_dict

    names, states = _param_names(optimizer), opt_sd["adamw"]["state"]
    mine = {"model": {k: v.detach().cpu() for k, v in model_sd.items()},
            **{m: {n: states[i][m].cpu() for i, n in enumerate(names)} for m in _MOMENTS}}
    shards = [None] * mesh.num_model
    dist.all_gather_object(shards, mine, group=mesh.model_group)
    full = {part: gather_state_dict([sh[part] for sh in shards], state.model.cfg)
            for part in mine}
    for i, n in enumerate(names):  # new dicts: the live optimizer state stays as it is
        states[i] = dict(states[i], **{m: full[m][n] for m in _MOMENTS})
    return full["model"], opt_sd


def save_state(mgr: CheckpointManager, step: int, state, optimizer, mesh=None) -> Optional[str]:
    """Save ``state`` (a ``TrainState``) and ``optimizer`` as checkpoint
    ``step``; keep the newest ``max_keep``.  Returns the file (None on a
    rank other than 0).  With a tensor-parallel ``mesh`` every rank calls
    it: the shards gather to rank 0, which writes the one-card format."""
    model_sd, opt_sd = _full_state(state, optimizer, mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    out = mgr.file(step)
    tmp = os.path.join(mgr.path, f".{step}.pt.{os.getpid()}.tmp")
    torch.save({"step": int(step), "model": model_sd, "optimizer": opt_sd}, tmp)
    os.replace(tmp, out)
    for old in mgr.steps()[:-mgr.max_keep]:
        os.remove(mgr.file(old))
    return out


def latest_step(mgr: CheckpointManager) -> Optional[int]:
    steps = mgr.steps()
    return steps[-1] if steps else None


def restore_state(mgr: CheckpointManager, state, optimizer, step: Optional[int] = None,
                  mesh=None):
    """Load checkpoint ``step`` (default: the latest) into ``state.model``
    and ``optimizer`` on the model's device; returns the state with the
    saved step.  With a tensor-parallel ``mesh`` the full file is cut into
    this rank's shards (``weights.shard_state_dict``)."""
    step = step if step is not None else latest_step(mgr)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {mgr.path}")
    dev = next(state.model.parameters()).device
    ckpt = torch.load(mgr.file(step), map_location=dev, weights_only=True)
    model_sd, opt_sd = ckpt["model"], ckpt["optimizer"]
    if mesh is not None and mesh.num_model > 1:
        from ..weights import shard_state_dict

        cfg, rank, n = state.model.cfg, mesh.model_index, mesh.num_model
        model_sd = shard_state_dict(model_sd, cfg, rank, n)
        states = opt_sd["adamw"]["state"]
        for i, name in enumerate(_param_names(optimizer)):
            for m in _MOMENTS:
                states[i][m] = shard_state_dict({name: states[i][m]}, cfg, rank, n)[name]
    state.model.load_state_dict(model_sd)
    optimizer.load_state_dict(opt_sd)
    return dataclasses.replace(
        state, step=torch.full_like(state.step, ckpt["step"]))
