"""The share (%) of the profiled train steps' span in which no kernel, copy
or set ran on the card (the union of device intervals)."""
from benchmark.metrics._common import idle


def read(trace):
    return idle(trace) if trace.kind == "train" else None
