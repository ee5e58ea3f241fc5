"""Optimizer and learning-rate schedule of the reference recipe; mirrors
``polyphonicformer_tpu/train/optim.py`` (configs/_base_/schedules: AdamW,
lr 1e-4 or 2e-4, weight decay 0.05, backbone lr_mult 0.25, global-norm
clip 1.0, linear warmup from ``warmup_ratio``, step decay; the stem and
``frozen_stages`` backbone stages frozen).

The JAX optax chain is, in order: frozen gradients zeroed, global-norm
clip over the trainable gradients, Adam (0.9, 0.999, eps 1e-8, bias
corrected), ``+ wd * p``, ``* lr_mult``, ``* -lr(t)``.  :class:`Optimizer`
computes the same update: frozen parameters have ``requires_grad=False``
and stay out of it; :meth:`Optimizer.clip_grads` is the clip;
``torch.optim.AdamW`` with one parameter group per ``lr_mult`` (group lr =
lr * lr_mult, decoupled decay lr * lr_mult * wd * p) and a ``LambdaLR`` of
the warmup and decay factor is the rest.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch


def is_frozen(name: str, frozen_stages: int = 1) -> bool:
    """Port parameter names: ``backbone.conv1``, ``backbone.bn1`` and
    ``backbone.layer{1..frozen_stages}`` are frozen."""
    parts = name.split(".")
    if parts[0] != "backbone" or len(parts) < 2:
        return False
    if parts[1] in ("conv1", "bn1"):
        return True
    return any(parts[1] == f"layer{s}" for s in range(1, frozen_stages + 1))


def lr_mult(name: str, backbone_lr_mult: float, frozen_stages: int = 1) -> float:
    if is_frozen(name, frozen_stages):
        return 0.0
    return backbone_lr_mult if name.startswith("backbone.") else 1.0


def lr_factor(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(t) / cfg.lr: linear warmup from ``warmup_ratio``, then x
    ``lr_decay_factor`` at each of ``lr_decay_epochs``."""
    def factor(step: int) -> float:
        warm = 1.0
        if step < cfg.warmup_iters:
            warm = 1.0 - (1.0 - cfg.warmup_ratio) * (1.0 - step / cfg.warmup_iters)
        decay = 1.0
        for e in cfg.lr_decay_epochs:
            if step >= e * steps_per_epoch:
                decay *= cfg.lr_decay_factor
        return warm * decay

    return factor


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(t), the JAX ``make_lr_schedule``."""
    factor = lr_factor(cfg, steps_per_epoch)
    return lambda step: cfg.lr * factor(step)


class Optimizer:
    """The JAX ``make_optimizer`` chain over a module's trainable parameters.

    ``state`` returns every tensor the update changes (parameters, Adam
    moments and step counts), for the train step's non-finite guard."""

    def __init__(self, model: torch.nn.Module, cfg, steps_per_epoch: int = 1,
                 frozen_stages: int = 1):
        groups: Dict[float, List[torch.nn.Parameter]] = {}
        for name, p in model.named_parameters():
            mult = lr_mult(name, cfg.backbone_lr_mult, frozen_stages)
            if (mult == 0.0) == p.requires_grad:
                raise ValueError(f"{name}: requires_grad={p.requires_grad} but lr_mult {mult}")
            if mult:
                groups.setdefault(mult, []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.names = {id(p): name for name, p in model.named_parameters()}
        self.max_norm = cfg.grad_clip_norm
        capturable = all(p.is_cuda for p in self.params)  # step counts on the card
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr": cfg.lr * mult} for mult, ps in groups.items()],
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
            foreach=True, capturable=capturable)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lr_factor(cfg, steps_per_epoch))
        # Adam state exists from the start, so the guard can snapshot it
        for p in self.params:
            self.adamw.state[p].update(
                step=torch.zeros((), dtype=torch.float32,
                                 device=p.device if capturable else "cpu"),
                exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        """Every trainable parameter's gradient, zeros where the backward
        gave none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def clip_grads(self) -> torch.Tensor:
        """optax ``clip_by_global_norm``: g * max_norm / norm when norm >=
        max_norm.  Returns the norm before the clip, on the device.  Under
        tensor parallelism the squares of the sharded gradients are summed
        over the model group and the replicated ones counted once."""
        grads = self.grads()
        norms = torch.stack(torch._foreach_norm(grads))
        norm = torch.linalg.vector_norm(norms)
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        return norm

    def state(self) -> List[torch.Tensor]:
        out = list(self.params)
        for p in self.params:
            st = self.adamw.state[p]
            out += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
        return out

    def step(self) -> None:
        self.adamw.step()
        self.scheduler.step()
