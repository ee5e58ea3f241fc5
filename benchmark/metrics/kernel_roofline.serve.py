"""The program's own kernels (the ``poly::`` ops) in the serve cells: the sum
of their calls' least times (``benchmark/roofline``) over the device time
of their kernels, in %."""
from benchmark.metrics._common import kernel_roofline


def read(trace):
    return kernel_roofline(trace) if trace.kind == "serve" else None
