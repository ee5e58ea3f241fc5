"""The image-model train step; mirrors ``polyphonicformer_tpu/train/step.py``.

One step: forward, every Hungarian matching, targets, losses, backward,
global-norm clip and AdamW (:mod:`.optim`), with a non-finite guard that
keeps the previous parameters and optimizer state (Adam moments and step
counts) when the loss or the gradient norm is not finite.  Nothing in the
step reads a value back to the host: the guard selects with
``torch.where`` on the device, so the host-side learning-rate schedule
advances on a skipped step too (the JAX schedule count does not).

``grad_norm`` in the metrics is the global norm of the trainable
gradients, the norm the clip sees.  The JAX metric also counts the
gradients of the frozen parameters, which the port does not compute
(they have ``requires_grad=False``, as in the reference).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch

from ..data.structures import TrainBatch
from ..models.polyphonic import PolyphonicFormer, init_weights
from .losses import compute_losses
from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # () int64 on the device; counts skipped steps too
    model: PolyphonicFormer  # f32 master weights, updated in place


def create_train_state(model: PolyphonicFormer, cfg, generator: torch.Generator | None = None,
                       steps_per_epoch: int = 1000, device="cuda"
                       ) -> Tuple[TrainState, Optimizer]:
    """Put ``model`` on ``device`` in f32 and train mode and build the
    optimizer of ``cfg`` (an ``ExperimentConfig``).  With a ``generator``
    the weights are drawn from it (``init_weights``; ``model`` may live on
    the meta device), as the JAX function initialises them from its key;
    without one the model keeps its weights."""
    if generator is not None:
        model = model.to_empty(device=device)
        init_weights(model, generator)
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
                    nan_guard: bool = True):
    """step(state, batch) -> (state, metrics): the loss dict plus
    ``total_loss``, ``grad_norm`` and (with ``nan_guard``)
    ``skipped_nonfinite``, all device tensors.  ``cfg``: an
    ``ExperimentConfig``.

    With ``compute_dtype='bfloat16'`` the forward and backward run on a
    bf16 copy of the model (parameters, frozen statistics and image cast
    to bf16, as the JAX step casts them), refreshed from the f32 master
    weights each step; its gradients, cast to f32, are the master weights'
    gradients (the cast's own gradient is the cast back)."""
    half = None
    if cfg.model.compute_dtype == "bfloat16":
        half = copy.deepcopy(model).to(torch.bfloat16)
        pairs = [(h, p) for h, p in zip(half.parameters(), model.parameters())
                 if p.requires_grad]

    def step(state: TrainState, batch: TrainBatch):
        image = batch.image
        if image.dtype == torch.uint8:
            image = normalize_uint8_image(image, cfg.data.mean, cfg.data.std)
        optimizer.zero_grad()
        if half is None:
            out = model(image)
        else:
            with torch.no_grad():
                torch._foreach_copy_([h for h, _ in pairs], [p for _, p in pairs])
            half.zero_grad(set_to_none=True)
            out = half(image.to(torch.bfloat16))
        total, losses = compute_losses(cfg.model, out, batch.gt)
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
