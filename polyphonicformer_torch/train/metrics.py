"""Structured metric logging (JSONL + stdout), replacing mmcv's
TextLoggerHook; mirrors ``polyphonicformer_tpu/train/metrics.py``.

reference: TextLoggerHook every 50 iterations + {timestamp}.log
(configs/_base_/default_runtime.py:1-18, tools/train.py:141-159).

Metric values may be device tensors: they are read back to the host only
on a step that is written, so the steps between cost no synchronisation.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, work_dir: str, log_interval: int = 50):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, f"{int(time.time())}.metrics.jsonl")
        self.log_interval = log_interval
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._last = self._t0

    def due(self, step: int) -> bool:
        return step % self.log_interval == 0

    def write(self, step: int, metrics: Dict) -> None:
        if not self.due(step):
            return
        now = time.time()
        rec = {"step": int(step), "time": round(now - self._t0, 1),
               "steps_per_sec": round(self.log_interval / max(now - self._last, 1e-9), 3)}
        rec.update({k: round(float(v), 6) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._last = now
        short = {k: rec[k] for k in ("step", "total_loss", "grad_norm", "steps_per_sec")
                 if k in rec}
        print(json.dumps(short), flush=True)

    def close(self) -> None:
        self._f.close()
