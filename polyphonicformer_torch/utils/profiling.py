"""Step timing and tracing; the port of
``polyphonicformer_tpu/utils/profiling.py``.

* ``trace_context(log_dir)`` wraps a code region in a ``torch.profiler``
  trace (the CPU, and the CUDA card where there is one) and writes it to
  ``log_dir`` as a Chrome trace (Perfetto, ``chrome://tracing``).
* ``span(name)`` marks a part of a step for a running ``torch.profiler``:
  ``with span("serve/fuse"): ...``.  While a profiler records it is a
  ``torch.profiler.record_function`` range, on the clock of the device's
  kernels and the CUDA runtime calls; otherwise one shared null context, so
  a span costs the read of the profiler's flag.  Names are
  ``<layer>/<part>``; every span of a step nests under its root,
  ``serve/step`` or ``train/step``.  The spans: ``serve/`` ``step``,
  ``network``, ``fuse``, ``detections``, ``track_embeds``, ``track``,
  ``render``, ``stack`` (``infer/pipeline.py``); ``model/`` ``backbone``,
  ``neck``, ``kernel_head``, ``stage``, ``track_head``
  (``models/polyphonic.py``), ``vit_window_attn``, ``vit_global_attn``
  (``models/vit.py``, inside ``model/backbone``); ``train/`` ``step``, ``prep``, ``cast``,
  ``forward_losses``, ``assign``, ``losses``, ``track_losses``,
  ``backward``, ``grad_cast``, ``reduce``, ``clip``, ``guard``,
  ``optimizer`` (``train/``).
* ``StepTimer`` measures steady-state step latency with warmup and reports
  percentiles, with the JAX timer's warmup and ``summary()`` keys.  CUDA
  launches return before the card finishes, so the timer synchronizes its
  device when a step ends: a step's time is its work on the card, not its
  launches.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace_context(log_dir: str):
    """Profile the region; on exit write ``log_dir/trace_<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """``with timer: step()`` for each step; the first ``warmup`` steps are
    not kept.  ``device``: the torch device the step runs on; a CUDA
    device is synchronized when a step ends."""

    def __init__(self, warmup: int = 2, *, device):
        self.warmup = warmup
        self.device = torch.device(device)
        self._times: List[float] = []
        self._count = 0
        self._t: Optional[float] = None

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(int(n * 0.9), n - 1)],
            "steps_per_sec": n / sum(ts),
        }
