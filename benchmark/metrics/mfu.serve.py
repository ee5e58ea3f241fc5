"""The whole serve step's share of the card's peak (%): the configuration's
FLOPs a step (``benchmark/roofline/model_flops.py``) times the profiled
steps, over their span, at the peak of the compute dtype."""
from benchmark.metrics._common import mfu


def read(trace):
    return mfu(trace) if trace.kind == "serve" else None
