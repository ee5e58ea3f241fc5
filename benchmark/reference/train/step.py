"""The 2-frame (and image) train step: forward, every Hungarian matching,
targets, losses (the ref frame's features and the track losses with
``video=True``), backward, global-norm clip and AdamW, with a non-finite
guard that keeps the previous parameters and optimizer state when the loss
or the gradient norm is not finite.  With bf16 compute the forward and
backward run on a bf16 copy refreshed from the f32 master weights each step.
``grad_norm`` is the global norm of the trainable gradients before the clip.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch

from ..data.structures import TrainBatch
from ..models.polyphonic import PolyphonicFormer
from .losses import compute_losses
from .optim import Optimizer
from .video_losses import video_forward_losses


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # () int64 on the device; counts skipped steps too
    model: PolyphonicFormer  # f32 master weights, updated in place


def create_train_state(model: PolyphonicFormer, cfg, steps_per_epoch: int = 1000,
                       device="cuda") -> Tuple[TrainState, Optimizer]:
    """Put ``model`` on ``device`` in f32 and train mode and build the
    optimizer of ``cfg`` (the experiment configuration)."""
    model = model.to(device=device, dtype=torch.float32).train()
    opt = Optimizer(model, cfg.schedule, steps_per_epoch, cfg.model.frozen_stages)
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=device), model=model), opt


def normalize_uint8_image(img: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std in f32 on the device, channel by channel (no
    host-to-device copy), with the configuration's ``DataConfig.mean`` /
    ``std``."""
    x = img.float()
    return torch.stack([(x[..., c] - mean[c]) / std[c] for c in range(3)], dim=-1)


def make_train_step(model: PolyphonicFormer, cfg, optimizer: Optimizer,
                    nan_guard: bool = True, video: bool = False, prepare=None):
    """step(state, batch) -> (state, metrics): the loss dict plus
    ``total_loss``, ``grad_norm`` and (with ``nan_guard``)
    ``skipped_nonfinite``, all device tensors.  ``cfg``: an
    ``ExperimentConfig``.

    With ``video`` the step trains on 2-frame batches (``ref_image`` and
    ``ref_gt`` set, ``cfg.model.with_track``): the key frame's losses plus
    the track losses (:func:`.video_losses.video_forward_losses`).

    With ``compute_dtype='bfloat16'`` the forward and backward run on a
    bf16 copy of the model (parameters, frozen statistics and images cast
    to bf16, as the JAX step casts them), refreshed from the f32 master
    weights each step; its gradients, cast to f32, are the master weights'
    gradients (the cast's own gradient is the cast back)."""
    if video and not cfg.model.with_track:
        raise ValueError("video training needs a model with a track head (with_track)")
    half = None
    if cfg.model.compute_dtype == "bfloat16":
        half = copy.deepcopy(model).to(torch.bfloat16)
        pairs = [(h, p) for h, p in zip(half.parameters(), model.parameters())
                 if p.requires_grad]
    if prepare is not None:  # a change of the computing copy (the controls)
        prepare(model if half is None else half)

    def prep(image):
        """A batch image normalised (uint8) and cast (bf16); None stays None."""
        if image is None:
            return None
        if image.dtype == torch.uint8:
            image = normalize_uint8_image(image, cfg.data.mean, cfg.data.std)
        return image if half is None else image.to(torch.bfloat16)

    def step(state: TrainState, batch: TrainBatch):
        if video and batch.ref_image is None:
            raise ValueError("a video train step needs a 2-frame batch (ref_image, ref_gt)")
        batch = batch._replace(image=prep(batch.image), ref_image=prep(batch.ref_image))
        optimizer.zero_grad()
        net = model
        if half is not None:
            with torch.no_grad():
                torch._foreach_copy_([h for h, _ in pairs], [p for _, p in pairs])
            half.zero_grad(set_to_none=True)
            net = half
        if video:
            total, losses = video_forward_losses(net, cfg.model, batch)
        else:
            total, losses = compute_losses(cfg.model, net(batch.image), batch.gt)
        total.backward()
        if half is not None:
            for h, p in pairs:
                p.grad = None if h.grad is None else h.grad.float()
        gnorm = optimizer.clip_grads()
        metrics: Dict[str, torch.Tensor] = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = gnorm
        if nan_guard:
            ok = torch.isfinite(total.detach()) & torch.isfinite(gnorm)
            before = [t.clone() for t in optimizer.state()]
        optimizer.step()
        if nan_guard:
            with torch.no_grad():
                for new, old in zip(optimizer.state(), before):
                    new.copy_(torch.where(ok, new, old))
            metrics["skipped_nonfinite"] = (~ok).float()
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
