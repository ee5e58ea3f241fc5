"""Multi-process host input pipelines through a shared-memory ring; mirrors
``polyphonicformer_tpu/data/mp_loader.py``.

Every sample has static shapes, so samples travel through preallocated
``multiprocessing.shared_memory`` slots (one memcpy a field, no pickle of
the ~93 MB 1024x2048 2-frame train sample).  Workers start with ``spawn``:
the parent holds CUDA state and threads, which ``fork`` would copy
unsafely.  This module imports ``torch`` only in the consumer, so a
worker's start-up imports numpy and the port's data modules, nothing more,
and no worker touches CUDA.

- Train (``MPTrainLoader``, the reference's DataLoader worker processes,
  mmdet/datasets/builder.py:86-190): workers run the whole scan, decode,
  augmentation and GT preparation, and resample rejected clips themselves.
  The consumer stitches batches from ready slots through
  ``loader.BatchSender`` (pinned staging, ``non_blocking`` copies, each
  staging set reused after its copies' CUDA event).  A worker that dies
  makes the consumer raise ``RuntimeError`` instead of waiting.
- Eval (``MPEvalLoader``): workers decode the PNG triplets, normalise and
  pad the image into a slot and write the GT frame dumps, so the consumer
  never touches GT; it copies each slot into a pinned staging tensor and
  sends it with ``.to(device, non_blocking=True)``, reusing a staging
  tensor only after the CUDA event recorded behind its last copy.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as queue_mod
import time
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .loader import BatchSender, make_sample
from .pipeline import padded_hw


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


def sample_field_specs(dc, mc, two_frame: bool) -> List[FieldSpec]:
    """Static layout of one train sample: the padded image (raw uint8 when
    the crop is divisor-aligned, normalised f32 otherwise) and its true
    (h, w), then the GT fields; with ``two_frame`` the same for the ref
    frame, prefixed ``ref_``."""
    ph, pw = padded_hw(dc)
    ah, aw = ph // mc.mask_assign_stride, pw // mc.mask_assign_stride
    mt, ns = mc.max_things, mc.num_stuff_classes
    img_dtype = "uint8" if (ph, pw) == tuple(dc.img_size) else "float32"
    per_frame = [
        ("image", (ph, pw, 3), img_dtype),
        ("image_hw", (2,), "int32"),
        ("thing_masks", (mt, ah, aw), "float32"),
        ("thing_labels", (mt,), "int32"),
        ("thing_valid", (mt,), "bool"),
        ("thing_inst_ids", (mt,), "int32"),
        ("stuff_masks", (ns, ah, aw), "float32"),
        ("stuff_valid", (ns,), "bool"),
        ("depth", (ah, aw), "float32"),
        ("valid_mask", (ah, aw), "float32"),
    ]
    specs = [FieldSpec(n, s, d) for n, s, d in per_frame]
    if two_frame:
        specs += [FieldSpec("ref_" + n, s, d) for n, s, d in per_frame]
    return specs


def _worker_main(wid: int, seed: int, shm_name: str, slots: int, specs: List[FieldSpec],
                 ds, dc, mc, two_frame: bool, free_q, ready_q) -> None:
    """Fill free ring slots with accepted samples until a None arrives."""
    import random

    from .loader import flat_sample
    from .pipeline import TrainPipeline

    ring = _Ring(specs, slots, create=False, name=shm_name)
    pipeline = TrainPipeline(dc, mc)
    rng = random.Random(seed * 100003 + wid)
    try:
        while True:
            slot = free_q.get()
            if slot is None:
                break
            sample = flat_sample(make_sample(ds, pipeline, two_frame, rng))
            views = ring.views(slot)
            for name, view in views.items():
                if name.endswith("image_hw"):
                    continue
                arr = sample[name]
                if name.endswith("image"):
                    h, w = arr.shape[:2]
                    views[name + "_hw"][...] = (h, w)
                    view[:h, :w] = arr
                else:
                    view[...] = arr
            ready_q.put(slot)
    finally:
        ring.close()


class MPTrainLoader:
    """Infinite shuffled train loader over worker processes, yielding
    ``TrainBatch``es on ``device``.  ``sample_wait_s`` counts the seconds
    the consumer has waited for ready slots."""

    def __init__(self, dataset, data_cfg, model_cfg, seed: int = 0,
                 num_workers: Optional[int] = None, device="cuda"):
        self.ds = dataset
        self.dc = data_cfg
        self.mc = model_cfg
        self.two_frame = bool(data_cfg.ref_seq_index)
        self.num_workers = max(1, num_workers or data_cfg.num_workers)
        self.specs = sample_field_specs(data_cfg, model_cfg, self.two_frame)
        self.slots = max(8, 2 * self.num_workers)
        self.seed = seed
        self.device = device
        self.sample_wait_s = 0.0
        self._ring: Optional[_Ring] = None
        self._procs: List[mp.process.BaseProcess] = []

    def start(self) -> "MPTrainLoader":
        from ..ops import native

        native.load()  # build the resize once here, not in every worker; raises if it fails
        ctx = mp.get_context("spawn")
        self._ring = _Ring(self.specs, self.slots, create=True)
        self._free_q = ctx.Queue()
        self._ready_q = ctx.Queue()
        for slot in range(self.slots):
            self._free_q.put(slot)
        for wid in range(self.num_workers):
            p = ctx.Process(
                target=_worker_main,
                args=(wid, self.seed, self._ring.shm.name, self.slots, self.specs, self.ds,
                      self.dc, self.mc, self.two_frame, self._free_q, self._ready_q),
                daemon=True)
            p.start()
            self._procs.append(p)
        return self

    def stop(self) -> None:
        for _ in self._procs:
            try:
                self._free_q.put(None)
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

    def _check_workers(self) -> None:
        dead = [(i, p.exitcode) for i, p in enumerate(self._procs) if p.exitcode is not None]
        if dead:
            raise RuntimeError(f"{len(dead)}/{len(self._procs)} train loader workers died "
                               f"(worker, exitcode) {dead}; check worker stderr")

    def _next_slot(self) -> int:
        t0 = time.perf_counter()
        while True:
            self._check_workers()
            try:
                slot = self._ready_q.get(timeout=1.0)  # then look for dead workers
                self.sample_wait_s += time.perf_counter() - t0
                return slot
            except queue_mod.Empty:
                continue

    def __iter__(self):
        if not self._procs:
            self.start()
        send = BatchSender(self.dc, self.two_frame, self.device)
        while True:
            slots = [self._next_slot() for _ in range(self.dc.batch_size)]
            samples = []
            for slot in slots:
                views = self._ring.views(slot)
                for name in [n for n in views if n.endswith("image_hw")]:
                    img = name[:-3]
                    h, w = (int(v) for v in views.pop(name))
                    views[img] = views[img][:h, :w]
                samples.append(views)
            batch = send(samples)  # the ring's bytes are in staging now
            for slot in slots:
                self._free_q.put(slot)
            yield batch


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
