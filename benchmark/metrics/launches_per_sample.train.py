"""Device kernels, copies and sets of the profiled train steps, over the
samples they trained."""
from benchmark.metrics._common import launches


def read(trace):
    if trace.kind != "train" or not trace.samples:
        return None
    return launches(trace) / trace.samples
