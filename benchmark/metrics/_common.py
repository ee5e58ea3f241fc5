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


def span_ms(trace, kind: str, names, what: str) -> float | None:
    """The span pass's ms a frame (serving) or sample (training) of the
    spans ``names``, children of the ``<kind>/step`` root: with ``what`` =
    "host", their host ms; with "idle", the idle ms of the gaps their
    launches ended (``spans.attribute``'s groups).  None in a run of
    another kind, without a span pass, or without a ``<kind>/step`` span
    (a program without spans)."""
    r = trace.spans
    units = trace.frames if kind == "serve" else trace.samples
    if trace.kind != kind or r is None or not units \
            or not r.rows.get(f"{kind}/step", {}).get("calls"):
        return None
    if what == "host":
        ms = sum(r.rows[n]["host_ms"] for n in names if n in r.rows)
    elif what == "idle":
        ms = sum(r.groups.get(n, 0.0) for n in names)
    else:
        raise ValueError(f"span_ms: what is {what!r}, not 'host' or 'idle'")
    return ms / units
