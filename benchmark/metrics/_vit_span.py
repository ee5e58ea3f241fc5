"""Device ms a served frame under one of the ViT's attention spans."""
from __future__ import annotations


def device_ms(trace, name: str) -> float | None:
    """The span pass's device ms of the launches made inside the span
    ``name``, over the frames of the profiled steps; None in a run of
    another kind, without a span pass, or without the span (a program
    without it)."""
    r = trace.spans
    if trace.kind != "serve" or r is None or not trace.frames:
        return None
    row = r.rows.get(name)
    if not row or not row["calls"]:
        return None
    return row["device_ms"] / trace.frames
