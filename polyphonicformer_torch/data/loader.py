"""The thread train loader and the batch transfer both train loaders share;
mirrors ``polyphonicformer_tpu/data/loader.py`` (``TrainLoader``; its
``_collate_gt`` and ``synthetic_batch`` are in :mod:`.synthetic`, and the
loaders stack their batches in :class:`BatchSender`).

Worker threads decode and augment clips while the card computes (the
GIL-bound debug backend; :mod:`.mp_loader` has the worker processes).
Rejected clips (an empty crop, no shared track id) are resampled as the
reference's ``_rand_another`` does (datasets/cityscapes_dvps.py:311-316),
each worker from its own ``random.Random(seed * 100003 + wid)``.

:class:`BatchSender` turns a batch of host samples into a ``TrainBatch``
on the device.  On a CUDA device it copies the samples into pinned staging
tensors and sends them with ``non_blocking`` copies on the current stream;
a staging set is reused only after the CUDA event recorded behind its
copies has completed, so the host runs ahead of the card by at most
``STAGING`` batches and never waits on the step it just queued.  A uint8
image shorter than the padded crop (an image smaller than the crop) is
normalised on the device and padded with 0 after the normalisation.

This module imports ``torch`` only inside functions, so a loader worker's
start-up imports numpy and the port's data modules, nothing more.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .pipeline import TrainPipeline, padded_hw

STAGING = 3  # pinned staging sets a BatchSender cycles through on a card
GT_FIELDS = ("thing_masks", "thing_labels", "thing_valid", "thing_inst_ids", "stuff_masks",
             "stuff_valid", "depth", "valid_mask")


def flat_sample(frames: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The pipeline's 1- or 2-frame output as one dict, the ref frame's
    fields prefixed ``ref_`` (the shared-memory ring's layout)."""
    out = dict(frames[0])
    if len(frames) == 2:
        out.update({"ref_" + k: v for k, v in frames[1].items()})
    return out


class BatchSender:
    """Host samples (``flat_sample`` dicts) -> ``TrainBatch`` on ``device``.

    A sample's image may be smaller than the padded crop (its true size):
    it goes to the top left of its slot, and the rest of the slot is set
    after the normalisation."""

    def __init__(self, data_cfg, two_frame: bool, device):
        import torch

        self.dc = data_cfg
        self.two_frame = two_frame
        self.device = torch.device(device)
        self._staging: List[Optional[Dict[str, "torch.Tensor"]]] = [None] * STAGING
        self._events: List[Optional["torch.cuda.Event"]] = [None] * STAGING
        self._next = 0
        self.pad_hw = padded_hw(data_cfg)

    def _buffers(self, samples):
        """(host tensors (B, ...) for each field, the CUDA event to record
        behind their copies or None)."""
        import torch

        b = len(samples)
        shapes = {}
        for name, v in samples[0].items():
            shape = (b,) + (self.pad_hw + (3,) if name.endswith("image") else v.shape)
            shapes[name] = (shape, torch.from_numpy(np.empty(0, v.dtype)).dtype)
        if self.device.type != "cuda":  # fresh tensors: a CPU batch aliases them
            return {n: torch.empty(s, dtype=d) for n, (s, d) in shapes.items()}, None
        k = self._next
        self._next = (k + 1) % STAGING
        if self._events[k] is not None:
            self._events[k].synchronize()
        bufs = self._staging[k]
        if bufs is None or any(bufs[n].shape != s or bufs[n].dtype != d
                               for n, (s, d) in shapes.items()):
            bufs = {n: torch.empty(s, dtype=d, pin_memory=True) for n, (s, d) in shapes.items()}
            self._staging[k] = bufs
        self._events[k] = torch.cuda.Event()
        return bufs, self._events[k]

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]):
        import torch

        from ..train.step import normalize_uint8_image
        from .structures import GTSample, TrainBatch

        bufs, event = self._buffers(samples)
        sizes = {}
        for name, buf in bufs.items():
            host = buf.numpy()
            if name.endswith("image"):
                sizes[name] = [s[name].shape[:2] for s in samples]
                for i, s in enumerate(samples):
                    h, w = s[name].shape[:2]
                    host[i, :h, :w] = s[name]
            else:
                for i, s in enumerate(samples):
                    host[i] = s[name]
        if event is None:
            dev = bufs
        else:
            dev = {n: b.to(self.device, non_blocking=True) for n, b in bufs.items()}
            event.record()

        def image(name):
            x = dev[name]
            if x.dtype == torch.uint8 and any(hw != self.pad_hw for hw in sizes[name]):
                # normalise, then pad with 0 (reference: Normalize before Pad)
                x = normalize_uint8_image(x, self.dc.mean, self.dc.std)
                for i, (h, w) in enumerate(sizes[name]):
                    x[i, h:] = 0
                    x[i, :, w:] = 0
            return x

        gt = GTSample(*(dev[f] for f in GT_FIELDS))
        if not self.two_frame:
            return TrainBatch(image=image("image"), gt=gt)
        ref_gt = GTSample(*(dev["ref_" + f] for f in GT_FIELDS))
        return TrainBatch(image=image("image"), gt=gt, ref_image=image("ref_image"),
                          ref_gt=ref_gt)


def make_sample(ds, pipeline: TrainPipeline, two_frame: bool, rng: random.Random
                ) -> List[Dict[str, np.ndarray]]:
    """One accepted clip: draw a key frame (and a ref frame), augment, and
    draw again while the pipeline rejects it (reference ``_rand_another``)."""
    while True:
        idx = rng.randrange(len(ds))
        pair = ds.get_pair(idx, rng)
        if pair is None:
            continue
        key, ref = pair
        frames = [ds.load_frame(key)]
        if two_frame:
            if ref is None:
                continue
            frames.append(ds.load_frame(ref))
        out = pipeline(frames, rng)
        if out is not None:
            return out


class TrainLoader:
    """Infinite shuffled train loader over background threads, yielding
    ``TrainBatch``es on ``device``.  ``sample_wait_s`` counts the seconds
    the consumer has waited for samples."""

    def __init__(self, dataset, data_cfg, model_cfg, seed: int = 0,
                 num_workers: Optional[int] = None, device="cuda"):
        self.ds = dataset
        self.dc = data_cfg
        self.mc = model_cfg
        self.pipeline = TrainPipeline(data_cfg, model_cfg)
        self.two_frame = bool(data_cfg.ref_seq_index)
        self.num_workers = num_workers or data_cfg.num_workers
        self.seed = seed
        self.device = device
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self.sample_wait_s = 0.0

    def _worker(self, wid: int):
        rng = random.Random(self.seed * 100003 + wid)
        try:
            while not self._stop.is_set():
                sample = flat_sample(make_sample(self.ds, self.pipeline, self.two_frame, rng))
                while not self._stop.is_set():
                    try:
                        self._queue.put(sample, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # reported to the consumer, which raises
            self._error = e
            raise

    def start(self) -> "TrainLoader":
        for wid in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(wid,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def _get(self):
        t0 = time.perf_counter()
        while True:
            try:
                sample = self._queue.get(timeout=1.0)
                self.sample_wait_s += time.perf_counter() - t0
                return sample
            except queue.Empty:
                if self._error is not None or not any(t.is_alive() for t in self._threads):
                    raise RuntimeError("train loader worker threads died") from self._error

    def __iter__(self) -> Iterator:
        if not self._threads:
            self.start()
        send = BatchSender(self.dc, self.two_frame, self.device)
        while True:
            yield send([self._get() for _ in range(self.dc.batch_size)])
