"""The traced run's reading of ``torch.profiler``: the device's kernels,
copies and sets inside the profiled steps, the ``poly::`` op calls with their
shapes, the host ops that were running when the device went idle, and the
card's idle time put down to the program's spans (:mod:`.spans`).

The profiles are kept in memory; no Chrome trace is written.  ``busy_us``,
``device_events`` and the library classes of ``KERNEL_CLASSES`` are copies
of the port's ``tools/profile_paths.py``; the ``port`` class is the union of
the roofline files' ``DEVICE_NAMES`` (``benchmark/roofline``).
"""
from __future__ import annotations

import dataclasses

from . import roofline, spans

SPAN = "benchmark.profiled_steps"

# device kernel name fragments -> class; the first class that matches wins
LIBRARY_CLASSES = (
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("matmul", ("gemm", "gemv", "cutlass", "cublas", "nvjet")),
    ("foreach", ("multi_tensor", "foreach")),
    ("norm", ("norm",)),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def kernel_classes(roofline_root=None) -> tuple:
    """(class, fragments) in order: the program's own kernels (``port``,
    from the roofline files in ``roofline_root``, default the package's),
    then the library classes."""
    return (("port", tuple(sorted(roofline.device_names(roofline_root)))),) + LIBRARY_CLASSES


KERNEL_CLASSES = kernel_classes()


def kernel_class(name: str, classes: tuple = KERNEL_CLASSES) -> str:
    low = name.lower()
    for cls, frags in classes:
        if any(f in low for f in frags):
            return cls
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_events(events):
    """(name, start_us, end_us) of every kernel, copy and set on the card;
    annotation spans on the device cover idle time and are left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


@dataclasses.dataclass
class Trace:
    """What a per-layer metric reads (``benchmark/metrics``)."""
    kind: str  # "serve" or "train"
    steps: int  # profiled steps
    frames: int  # frames served in them (serving)
    samples: int  # samples trained in them (training)
    span_s: float  # their span on the host clock, synchronized at both ends
    busy_s: float  # union of their device intervals
    device: list  # (name, start_us, end_us) of their kernels, copies and sets
    ops: list  # (name, shapes, dtypes, scalars) of the poly:: calls of the shape pass
    port_s: float  # device seconds of the program's own kernels in the shape pass
    step_flops: float  # the configuration's FLOPs of one step
    compute_dtype: str  # the dtype whose peak bounds the step
    spans: spans.Reading | None = None  # the span pass's idle by span and group


def profile_steps(run_step, n: int, sync):
    """Three passes of ``n`` steps each, ``run_step()`` driving one step.
    The device pass profiles CUDA activity alone, so the host runs at
    nearly its own pace: the kernels, the busy time and the span on the host
    clock, synchronized at both ends.  The shape pass adds the host's ops
    with their shapes (the ``poly::`` calls for the roofline, the host op
    behind each idle gap); its host is slowed by the recording.  The span
    pass (:func:`spans.span_pass`) records the program's spans and the
    launches beside the device's intervals, without shapes.  Returns
    (device profile, span seconds, shape profile, span profile)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    # a CPU-only build (the harness's own tests) has no CUDA activity to trace
    device = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    sync()
    with profile(activities=[device]) as dev_prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        sync()
        span = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as ops_prof:
        with record_function(SPAN):
            for _ in range(n):
                run_step()
            sync()
    span_prof = spans.span_pass(run_step, n, sync)
    return dev_prof, span, ops_prof, span_prof


def read(dev_prof, span_s: float, ops_prof, span_prof, kind: str, steps: int, frames: int,
         samples: int, step_flops: float, compute_dtype: str) -> tuple[Trace, dict]:
    """The Trace of :func:`profile_steps` and its breakdown: the device ops
    that took most time (by kernel name, then by class) in the device pass,
    and the longest idle gaps of the shape pass, each named by the innermost
    host op running when it began."""
    dev = device_events(dev_prof.events())
    events = ops_prof.events()
    span = [e for e in events if e.name == SPAN and e.device_type.name == "CPU"]
    if not span:
        raise RuntimeError("the shape pass has no span of the profiled steps")
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    ops_dev = [(n, max(s, t0), min(e, t1)) for n, s, e in device_events(events)
               if e > t0 and s < t1]
    port = sum(e - s for n, s, e in ops_dev if kernel_class(n) == "port") / 1e6
    trace = Trace(kind=kind, steps=steps, frames=frames, samples=samples, span_s=span_s,
                  busy_s=busy_us((s, e) for _, s, e in dev) / 1e6, device=dev,
                  ops=poly_calls(ops_prof), port_s=port, step_flops=step_flops,
                  compute_dtype=compute_dtype,
                  spans=spans.attribute(*spans.from_profile(span_prof)))
    return trace, {"device_ops": _top_ops(dev), "idle_gaps": _idle_gaps(events, ops_dev, t0, t1)}


def poly_calls(prof) -> list:
    """(name, shapes, dtypes, scalars) of every ``poly::`` op call, in
    order: shapes and scalars from the profile's events, dtypes from the
    underlying kineto events (the events of some torch versions lack
    them)."""
    fn = sorted((e for e in prof.events()
                 if e.name.startswith("poly::") and e.device_type.name == "CPU"),
                key=lambda e: e.time_range.start)
    kin = sorted((k for k in prof.profiler.kineto_results.events()
                  if k.name().startswith("poly::") and k.device_type().name == "CPU"),
                 key=lambda k: k.start_ns())
    if len(kin) != len(fn):
        raise RuntimeError(f"{len(fn)} poly:: calls in the profile, {len(kin)} kineto events")
    return [(e.name, [list(s) for s in e.input_shapes], [str(d) for d in k.dtypes()],
             list(getattr(e, "concrete_inputs", None) or k.concrete_inputs()))
            for e, k in zip(fn, kin)]


def _top_ops(dev) -> list:
    by_name, by_class = {}, {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        c = kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    classes = sorted(by_class.items(), key=lambda kv: -kv[1])[:4]
    return [[n[:120], v] for n, v in top] + [[f"class:{c}", v] for c, v in classes]


def _idle_gaps(events, dev, t0, t1) -> list:
    gaps, end = [], t0
    for s, e in sorted((s, e) for _, s, e in dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in events if e.device_type.name == "CPU" and e.name != SPAN]
    out = []
    for g0, g1 in gaps:
        inside = [e for e in host if e.time_range.start <= g0 < e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inside else "(no host op)"
        out.append([name[:120], (g1 - g0) / 1e6])
    return out
