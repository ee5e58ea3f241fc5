"""K10's global mode (ViTDet's global blocks, 8,192 tokens at 1024x2048) in
the serve cells: its calls' least time over its kernels' device time, in %."""
from benchmark.metrics._relpos import share


def read(trace):
    return share(trace, global_mode=True)
