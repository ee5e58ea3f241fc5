"""Device kernels, copies and sets of the profiled serving steps, over the
frames they served."""
from benchmark.metrics._common import launches


def read(trace):
    if trace.kind != "serve" or not trace.frames:
        return None
    return launches(trace) / trace.frames
