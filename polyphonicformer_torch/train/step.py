"""The train step of the image model and of the 2-frame video model;
mirrors ``polyphonicformer_tpu/train/step.py``.

One step: forward, every Hungarian matching, targets, losses (with
``video=True`` the ref frame's features and the track losses too,
:mod:`.video_losses`), backward,
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

Distributed (``parallel/mesh.py``): :func:`make_sharded_train_step` is
the step of one data-parallel rank, its batch the rank's part of the
global batch.  Every loss is the global batch's (``global_sums`` in the
losses), the f32 gradients are summed over the data axis through one flat
buffer in a fixed order, and the clip and the non-finite guard read the
summed values, so every rank takes the same update and holds the same
bits.  :func:`make_tp_train_setup` adds the model axis: a Swin backbone
sharded by heads (``models/swin.py``), its replicated gradients averaged
and its bias tables' summed over the model axis, the clip's norm over
the full gradients (``optim.Optimizer.clip_grads``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch

from ..data.structures import TrainBatch
from ..models.polyphonic import PolyphonicFormer, build_model, init_weights
from ..parallel.mesh import Mesh, all_reduce_flat, broadcast_module, data_parallel_losses
from ..parallel.tensor_parallel import model_parallel, param_layout
from ..utils.profiling import span
from .losses import compute_losses
from .optim import Optimizer
from .video_losses import video_forward_losses


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


def _gradient_reducer(model: PolyphonicFormer, optimizer: Optimizer, mesh: Mesh):
    """reduce() of the f32 gradients of one step on ``mesh``: over the model
    axis the replicated ones averaged (equal on every model rank but for
    the order of a card's sums) and the partial ones (bias tables) summed;
    then every one summed over the data axis.  One flat buffer an axis, in
    the optimizer's order."""
    layout = param_layout(model)
    names = [optimizer.names[id(p)] for p in optimizer.params]
    if mesh.num_model > 1:
        optimizer.set_model_parallel({n for n, kind in layout.items() if kind == "sharded"},
                                     mesh.model_group)
    unsharded = [i for i, n in enumerate(names) if layout[n] != "sharded"]
    replicated = [i for i in unsharded if layout[names[i]] == "replicated"]

    def reduce() -> None:
        grads = optimizer.grads()
        if mesh.num_model > 1:
            torch._foreach_mul_([grads[i] for i in replicated], 1.0 / mesh.num_model)
            all_reduce_flat([grads[i] for i in unsharded], mesh.model_group)
        all_reduce_flat(grads, mesh.data_group)

    return reduce


def make_train_step(model: PolyphonicFormer, cfg, optimizer: Optimizer,
                    nan_guard: bool = True, video: bool = False, mesh: Mesh | None = None):
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
    gradients (the cast's own gradient is the cast back).

    ``mesh``: the step of one rank of a distributed job; use
    :func:`make_sharded_train_step`, which also makes the ranks' weights
    equal first."""
    if video and not cfg.model.with_track:
        raise ValueError("video training needs a model with a track head (with_track)")
    half = None
    if cfg.model.compute_dtype == "bfloat16":
        half = copy.deepcopy(model).to(torch.bfloat16)
        pairs = [(h, p) for h, p in zip(half.parameters(), model.parameters())
                 if p.requires_grad]

    reduce = None if mesh is None else _gradient_reducer(model, optimizer, mesh)

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
        with span("train/step"):
            with span("train/prep"):
                batch = batch._replace(image=prep(batch.image), ref_image=prep(batch.ref_image))
            optimizer.zero_grad()
            net = model
            if half is not None:
                with span("train/cast"), torch.no_grad():
                    torch._foreach_copy_([h for h, _ in pairs], [p for _, p in pairs])
                half.zero_grad(set_to_none=True)
                net = half
            with span("train/forward_losses"), data_parallel_losses(mesh):
                if video:
                    total, losses = video_forward_losses(net, cfg.model, batch)
                else:
                    total, losses = compute_losses(cfg.model, net(batch.image), batch.gt)
            with span("train/backward"):
                total.backward()
            if half is not None:
                with span("train/grad_cast"):
                    for h, p in pairs:
                        p.grad = None if h.grad is None else h.grad.float()
            if reduce is not None:
                with span("train/reduce"):
                    reduce()
            with span("train/clip"):
                gnorm = optimizer.clip_grads()
            metrics: Dict[str, torch.Tensor] = {k: v.detach() for k, v in losses.items()}
            metrics["total_loss"] = total.detach()
            metrics["grad_norm"] = gnorm
            if nan_guard:
                with span("train/guard"):
                    ok = torch.isfinite(total.detach()) & torch.isfinite(gnorm)
                    before = [t.clone() for t in optimizer.state()]
            with span("train/optimizer"):
                optimizer.step()
            if nan_guard:
                with span("train/guard"), torch.no_grad():
                    for new, old in zip(optimizer.state(), before):
                        new.copy_(torch.where(ok, new, old))
                    metrics["skipped_nonfinite"] = (~ok).float()
            return dataclasses.replace(state, step=state.step + 1), metrics

    return step


def make_sharded_train_step(model: PolyphonicFormer, cfg, optimizer: Optimizer, mesh: Mesh,
                            nan_guard: bool = True, video: bool = False):
    """The train step of one rank on ``mesh`` (the counterpart of the JAX
    ``make_sharded_train_step``): step(state, local_batch), the local batch
    this rank's part of the global batch (``parallel.mesh.local_slice``).
    First every parameter and buffer comes from data index 0 of the rank's
    data group, so the ranks start equal.  A W-rank step at local batch b
    is the one-rank step at batch W x b; every rank returns the same
    metrics and holds the same parameters after it."""
    broadcast_module(model, mesh.data_group)
    return make_train_step(model, cfg, optimizer, nan_guard=nan_guard, video=video, mesh=mesh)


def make_tp_train_setup(cfg, mesh: Mesh, generator: torch.Generator | None = None,
                        state_dict=None, video: bool = False, steps_per_epoch: int = 1000):
    """Tensor-parallel training over a (data, model) mesh (the JAX
    ``make_tp_train_setup``): returns (state, step, optimizer) of this rank.
    The model is ``build_model`` of ``cfg.model`` (``shard_backbone``) on
    the mesh's device with this rank's shards, from the full weights of
    ``generator`` or ``state_dict``; AdamW's moments take the shards'
    shapes; batches split over the data axis (:func:`make_sharded_train_step`)."""
    model = build_model(cfg.model, mesh.device, generator=generator, state_dict=state_dict,
                        tp=model_parallel(mesh))
    state, opt = create_train_state(model, cfg, None, steps_per_epoch, device=mesh.device)
    return state, make_sharded_train_step(state.model, cfg, opt, mesh, video=video), opt
