"""K10's window mode (ViTDet's window blocks, 14 x 14 = 196 tokens) in the
serve cells: its calls' least time over its kernels' device time, in %."""
from benchmark.metrics._relpos import share


def read(trace):
    return share(trace, global_mode=False)
