"""Ordered multi-process eval decode through a shared-memory ring; the eval
half of ``polyphonicformer_tpu/data/mp_loader.py`` (``FieldSpec``,
``_Ring``, ``_eval_worker_main``, ``MPEvalLoader``).

Worker processes decode the PNG triplets, normalise and pad the image into
a preallocated ``multiprocessing.shared_memory`` slot (one memcpy, no pickle
of the 24 MB 1024x2048 float32 frame) and write the GT frame dumps, so the
consumer never touches GT.  Workers start with ``spawn``: the parent holds
CUDA state and threads, which ``fork`` would copy unsafely.  This module
imports ``torch`` only in the consumer, so a worker's start-up imports numpy
and the port's data modules, nothing more.

On a CUDA device the consumer copies each ring slot into a pinned host
staging tensor and sends it with ``.to(device, non_blocking=True)`` on the
current stream; a staging tensor is reused only after the CUDA event
recorded behind its last copy has completed.  The train half (augmenting
workers, ``MPTrainLoader``) waits for the training CLI.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as queue_mod
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


class _Ring:
    """Preallocated shared-memory slots, each holding one flat sample."""

    def __init__(self, specs: Sequence[FieldSpec], slots: int,
                 create: bool, name: Optional[str] = None):
        self.specs = list(specs)
        self.slot_bytes = sum(s.nbytes for s in self.specs)
        self.slots = slots
        total = self.slot_bytes * slots
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=total)
        else:
            self.shm = shared_memory.SharedMemory(name=name)

    def views(self, slot: int) -> Dict[str, np.ndarray]:
        out = {}
        off = slot * self.slot_bytes
        for s in self.specs:
            out[s.name] = np.ndarray(s.shape, dtype=s.dtype,
                                     buffer=self.shm.buf, offset=off)
            off += s.nbytes
        return out

    def close(self, unlink: bool = False):
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


def _eval_worker_main(wid: int, shm_name: str, slots: int,
                      specs: List[FieldSpec], ds, dc,
                      gt_dir: Optional[str], task_q, ready_q) -> None:
    """Decode eval frames into ring slots, in whatever order tasks arrive.

    Each task is (order, frame_index, slot).  The worker also writes the GT
    frame dump (reference dataset.pre_eval's gt side,
    datasets/cityscapes_dvps.py:340-348) so the consumer never touches GT.
    """
    from ..evalutils.dvpq import save_frame
    from .pipeline import make_test_input

    ring = _Ring(specs, slots, create=False, name=shm_name)
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            order, idx, slot = task
            info = ds.images[idx]
            frame = ds.load_frame(info, segments=False)
            inp = make_test_input(frame, dc)
            views = ring.views(slot)
            views["image"][...] = inp["image"]
            if gt_dir is not None:
                # depth came off disk as uint16/256 (clamped at 80 m, an
                # exact uint16 value): re-encoding to the same grid is
                # lossless and compresses faster than float32
                d16 = np.round(frame["depth"] * 256.0).astype(np.uint16)
                save_frame(gt_dir, "gt", info["seq_id"], info["img_id"],
                           frame["pan"], d16)
            ready_q.put((order, slot))
    finally:
        ring.close()


class MPEvalLoader:
    """Deterministic-order eval frame decoder over worker processes.

    Yields (info, image) in exactly the order of ``frame_infos``, image a
    (ph, pw, 3) float32 tensor on ``device``; decode runs ahead on
    ``num_workers`` processes through a shared-memory ring of
    ``2 * num_workers`` slots.
    """

    def __init__(self, dataset, frame_infos, data_cfg, padded_hw: Tuple[int, int],
                 num_workers: int = 4, gt_dir: Optional[str] = None, device="cuda"):
        self.ds = dataset
        self.dc = data_cfg
        self.infos = list(frame_infos)
        # indices into ds.images (ring tasks carry indices, not dicts)
        by_key = {(f["seq_id"], f["img_id"]): i
                  for i, f in enumerate(dataset.images)}
        self.indices = [by_key[(f["seq_id"], f["img_id"])] for f in self.infos]
        ph, pw = padded_hw
        self.specs = [FieldSpec("image", (ph, pw, 3), "float32")]
        self.num_workers = max(1, num_workers)
        self.slots = 2 * self.num_workers
        self.gt_dir = gt_dir
        self.device = device
        self._procs: List[mp.process.BaseProcess] = []
        self._ring: Optional[_Ring] = None

    def __enter__(self) -> "MPEvalLoader":
        ctx = mp.get_context("spawn")
        self._ring = _Ring(self.specs, self.slots, create=True)
        self._task_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        for wid in range(self.num_workers):
            p = ctx.Process(
                target=_eval_worker_main,
                args=(wid, self._ring.shm.name, self.slots, self.specs,
                      self.ds, self.dc, self.gt_dir, self._task_q,
                      self._ready_q),
                daemon=True)
            p.start()
            self._procs.append(p)
        return self

    def __exit__(self, *exc) -> None:
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except (OSError, ValueError):  # queue already closed
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []
        if self._ring is not None:
            self._ring.close(unlink=True)
            self._ring = None

    def _get_ready(self):
        idle = 0
        while True:
            try:
                return self._ready_q.get(timeout=10)
            except queue_mod.Empty:
                idle += 1
                dead = [p.exitcode for p in self._procs if not p.is_alive()]
                if dead and (len(dead) == len(self._procs) or idle >= 3):
                    raise RuntimeError(
                        f"{len(dead)}/{len(self._procs)} eval decode workers "
                        f"died (exitcodes {dead}); check worker stderr")

    def __iter__(self):
        import torch

        dev = torch.device(self.device)
        shape = self.specs[0].shape
        # pinned staging tensors, each reused only after its last copy's event
        staging = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                   for _ in range(self.slots)] if dev.type == "cuda" else []
        copied: List[Optional[torch.cuda.Event]] = [None] * len(staging)
        n = len(self.indices)
        next_task = 0
        # seed every slot with a task
        for slot in range(min(self.slots, n)):
            self._task_q.put((next_task, self.indices[next_task], slot))
            next_task += 1
        stash = {}
        for expect in range(n):
            while expect not in stash:
                order, slot = self._get_ready()
                stash[order] = slot
            slot = stash.pop(expect)
            view = self._ring.views(slot)["image"]
            if staging:
                k = expect % len(staging)
                if copied[k] is not None:
                    copied[k].synchronize()
                staging[k].numpy()[...] = view
                image = staging[k].to(dev, non_blocking=True)
                copied[k] = torch.cuda.Event()
                copied[k].record()
            else:
                image = torch.from_numpy(np.array(view, copy=True)).to(dev)
            if next_task < n:
                self._task_q.put((next_task, self.indices[next_task], slot))
                next_task += 1
            yield self.infos[expect], image
