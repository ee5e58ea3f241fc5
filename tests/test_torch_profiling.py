"""The port's ``utils/profiling.py``: ``StepTimer`` against the JAX
package's on one patched ``time.perf_counter`` (the same warmup, the same
summary), and ``trace_context`` writing a Chrome trace."""
import json
import time

import pytest
import torch

from polyphonicformer_tpu.utils import profiling as jax_profiling
from polyphonicformer_torch.utils import profiling


@pytest.mark.parametrize("warmup,steps", [(2, 7), (0, 3), (3, 3)])
def test_step_timer_matches_jax(warmup, steps, monkeypatch):
    durations = [0.5, 0.25, 0.125, 1.0, 0.375, 2.0, 0.0625][:steps]

    def run(timer):
        clock = iter([t for i, d in enumerate(durations) for t in (10.0 * i, 10.0 * i + d)])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for _ in durations:
            with timer:
                pass
        return timer.summary()

    got = run(profiling.StepTimer(warmup, device="cpu"))
    want = run(jax_profiling.StepTimer(warmup))
    assert got == want
    assert (got == {}) == (steps <= warmup)


def test_trace_context_writes_trace(tmp_path):
    with profiling.trace_context(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = tmp_path.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
