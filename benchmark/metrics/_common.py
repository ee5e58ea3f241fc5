"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from benchmark import roofline
from benchmark.roofline.peaks import FLOPS_PER_S


def launches(trace) -> int:
    """Device kernels, copies and sets inside the profiled steps."""
    return len(trace.device)


def mfu(trace) -> float | None:
    """The configuration's FLOPs of the profiled steps over their span, as
    a share (%) of the compute dtype's peak."""
    if trace.span_s <= 0 or not trace.steps:
        return None
    rate = trace.step_flops * trace.steps / trace.span_s
    return 100.0 * rate / FLOPS_PER_S[trace.compute_dtype]


def kernel_roofline(trace) -> float | None:
    """Sum of the poly:: calls' least times over the device time of the
    program's own kernels, both of the shape pass (%); None when either is
    not there."""
    least = 0.0
    for name, shapes, dtypes, scalars in trace.ops:
        t = roofline.least_seconds(name, shapes, dtypes, scalars)
        if t is not None:
            least += t
    if least <= 0 or trace.port_s <= 0:
        return None
    return 100.0 * least / trace.port_s


def idle(trace) -> float | None:
    """The share (%) of the profiled span in which nothing ran on the card."""
    if trace.span_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.span_s)
