"""The (data, model) mesh over ``torch.distributed``; the counterpart of
``polyphonicformer_tpu/parallel/mesh.py``.

JAX runs one SPMD program over a device mesh and XLA inserts the
collectives.  The port runs one process a rank, as ``torchrun`` does, and
calls each collective itself: the data-parallel gradient sum
(``train/step.py``), the loss normalizers (:func:`global_sums`), the
tensor-parallel all-reduces (``parallel/tensor_parallel.py``) and the
evaluation gathers (``evalutils/runner.py``).

Ranks lie on the mesh as JAX lays its devices: rank = data index x
num_model + model index.  A rank has one device.  NCCL joins ranks that
each have a card of their own; gloo joins ranks on the CPU, or ranks that
share one card (NCCL refuses two ranks on one GPU), and then every
collective on a CUDA tensor goes through host memory (:func:`_transport`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..configs import ParallelConfig

# tools/launch.py --store-file: rendezvous through a FileStore instead of TCP
STORE_ENV = "POLY_STORE_FILE"
# tools/launch.py --sim-cpu: the ranks run on the CPU
DEVICE_ENV = "POLY_DEVICE"


def _launched() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: ``device`` (default: ``$POLY_DEVICE``, else
    ``cuda``); a CUDA device is the card ``LOCAL_RANK % device_count``.
    Raises when a card is asked for and there is none."""
    name = device or os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(name)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: no CUDA card found; ask for the CPU "
                           "(--device cpu, or tools/launch.py --sim-cpu)")
    if dev.index is None and _launched():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def _pick_backend(dev: torch.device, backend: Optional[str]) -> str:
    """NCCL when every rank on this host has a card of its own, gloo when
    ranks share a card or run on the CPU.  NCCL asked for on a shared card
    or on the CPU raises."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    own_card = dev.type == "cuda" and local_world <= torch.cuda.device_count()
    if backend is None:
        return "nccl" if own_card else "gloo"
    if backend == "nccl" and not own_card:
        where = ("the CPU" if dev.type != "cuda" else
                 f"{local_world} ranks on {torch.cuda.device_count()} card(s)")
        raise RuntimeError(f"NCCL needs a card of its own for every rank, not {where}: "
                           "use gloo")
    return backend


def init_distributed(device: Optional[str] = None, backend: Optional[str] = None
                     ) -> torch.device:
    """Join the job the launcher started and return this rank's device
    (:func:`rank_device`).  Reads the environment the launcher and torchrun
    export (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), or a FileStore's path in ``$POLY_STORE_FILE`` in place
    of the address.  Outside a launched job it joins nothing and only picks
    the device; in a process that has joined already, too.  The backend:
    :func:`_pick_backend`."""
    dev = rank_device(device)
    if dist.is_initialized() or not _launched():
        return dev
    store = os.environ.get(STORE_ENV)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _pick_backend(dev, backend)
    dist.init_process_group(backend, init_method=f"file://{store}" if store else None,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            device_id=dev if backend == "nccl" else None)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (num_data, num_model) mesh and the process
    groups of its two axes (None on one process)."""
    num_data: int
    num_model: int
    rank: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]
    device: torch.device

    @property
    def world(self) -> int:
        return self.num_data * self.num_model


def make_mesh(cfg: Optional[ParallelConfig] = None, device=None) -> Mesh:
    """The mesh of ``cfg`` over every rank of the job (``num_data`` -1:
    world / num_model).  Every rank calls it, in the same order as every
    other group it makes.  Without a process group: a 1 x 1 mesh."""
    cfg = cfg or ParallelConfig()
    dev = torch.device(device) if device is not None else rank_device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    num_model = max(cfg.num_model, 1)
    num_data = cfg.num_data if cfg.num_data > 0 else world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data} x {num_model} does not cover the {world} ranks")
    data_group = model_group = None
    if dist.is_initialized():
        for m in range(num_model):  # every rank makes every group, in one order
            g = dist.new_group([d * num_model + m for d in range(num_data)])
            if rank % num_model == m:
                data_group = g
        for d in range(num_data):
            g = dist.new_group([d * num_model + m for m in range(num_model)])
            if rank // num_model == d:
                model_group = g
    return Mesh(num_data, num_model, rank, rank // num_model, rank % num_model,
                data_group, model_group, dev)


def _transport(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective over ``group`` runs on.  Gloo between ranks
    that share a card does not take every collective on a CUDA tensor, so
    under gloo a CUDA tensor is copied to host memory, and the caller copies
    the result back: the transport between ranks on one card (the compute
    stays on the card).  NCCL takes CUDA tensors only: a host tensor (the
    evaluation's statistics) goes to this rank's card.  This is the one
    place that decides it."""
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return t.detach().cpu()
    if not t.is_cuda and backend == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing without a group)."""
    if group is None:
        return t
    x = _transport(t, group)
    dist.all_reduce(x, group=group)
    return t if x is t else t.copy_(x)


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of the group's first rank on every rank, in place."""
    if group is None:
        return t
    x = _transport(t, group)
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return t if x is t else t.copy_(x)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) stacked on a new leading axis in
    group-rank order.  bool and bf16 travel as their bytes (gloo takes
    neither)."""
    if group is None:
        return t[None]
    wire = {torch.bool: torch.uint8, torch.bfloat16: torch.int16}.get(t.dtype)
    x = _transport(t.contiguous() if wire is None else t.contiguous().view(wire), group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts).to(t.device)
    return out if wire is None else out.view(t.dtype)


def world_group():
    """The group of every rank, or None on one process."""
    return dist.group.WORLD if dist.is_initialized() and dist.get_world_size() > 1 else None


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` (one dtype) over ``group`` in place through one flat
    buffer in the given order, so every rank adds the same numbers in the
    same order and holds the same bits."""
    if group is None or not tensors:
        return
    flat = all_reduce(_flat(tensors), group)
    _unflat_into(flat, tensors)


def broadcast_module(module: torch.nn.Module, group) -> None:
    """Every parameter and buffer of ``module`` from the group's first rank
    (one flat buffer a dtype)."""
    if group is None:
        return
    by_dtype: dict = {}
    for t in [*module.parameters(), *module.buffers()]:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = broadcast(_flat(ts), group)
            _unflat_into(flat, ts)


def local_slice(x, mesh: Mesh, axis: int = 0):
    """This rank's rows of a global batch (the data index's equal part of
    ``axis``); tuples (NamedTuples too) and None map through.  The
    counterpart of ``shard_batch_pytree`` / ``global_put``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(local_slice(v, mesh, axis) for v in x))
    n = x.shape[axis]
    if n % mesh.num_data:
        raise ValueError(f"a batch of {n} does not split over {mesh.num_data} data ranks")
    per = n // mesh.num_data
    return x.narrow(axis, mesh.data_index * per, per)


# ---------------------------------------------------------------- loss sums
# JAX computes each loss over the global batch inside one program
# (polyphonicformer_tpu/train/losses.py:14-17).  Under data parallelism every
# sum that a loss divides, or combines in any other way, is summed over the
# data axis first: global_sums.

_LOSS_GROUP: List[Optional[Mesh]] = [None]


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward.  As a loss sum: every
    rank reads the global value and its backward reaches only its own
    samples; the train step sums the gradients over the ranks.  As
    Megatron's row-parallel reduction the same."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().contiguous()  # gradients of a bf16 copy reduce in f32
        return all_reduce(g32, ctx.group).to(g.dtype), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, identity gradient (:class:`_SumOverGroup`)."""
    return x if group is None else _SumOverGroup.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, its gradient summed over ``group`` (:class:`_CopyToGroup`)."""
    return x if group is None else _CopyToGroup.apply(x, group)


@contextlib.contextmanager
def data_parallel_losses(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside: :func:`global_sums` sums over ``mesh``'s data axis (nothing
    when ``mesh`` is None or has one data rank)."""
    prev = _LOSS_GROUP[0]
    _LOSS_GROUP[0] = mesh if mesh is not None and mesh.num_data > 1 else None
    try:
        yield
    finally:
        _LOSS_GROUP[0] = prev


def data_world() -> int:
    """The data ranks :func:`global_sums` sums over (1 outside
    :func:`data_parallel_losses`): the global batch is this times the local."""
    mesh = _LOSS_GROUP[0]
    return 1 if mesh is None else mesh.num_data


def global_sums(*xs: torch.Tensor):
    """``xs`` (f32 tensors of any shapes) summed over the data axis in one
    collective, each with an identity gradient; on one rank ``xs`` as they
    are.  Returns a tuple."""
    mesh = _LOSS_GROUP[0]
    if mesh is None:
        return xs
    total = _SumOverGroup.apply(_flat([x.float() for x in xs]), mesh.data_group)
    out, i = [], 0
    for x in xs:
        out.append(total[i:i + x.numel()].view(x.shape))
        i += x.numel()
    return tuple(out)
