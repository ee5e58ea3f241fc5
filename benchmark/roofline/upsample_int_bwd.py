"""K2b, ``poly::upsample_int_bwd(g (N, fy h, fx w) f32, fy, fx) -> (N, h, w)
f32``: the gradient read once, the input gradient written once; each
gradient element feeds two taps along each axis, 6 operations."""
from benchmark.roofline import numel

DEVICE_NAMES = ("upsample_int",)


def cost(shapes, dtypes, scalars):
    fy, fx = int(scalars[1]), int(scalars[2])
    n_g = numel(shapes[0])
    return 4 * n_g + 4 * (n_g // (fy * fx)), 6.0 * n_g, "float32"
