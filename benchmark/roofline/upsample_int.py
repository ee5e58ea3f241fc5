"""K2, ``poly::upsample_int(x (N, h, w) f32, fy, fx) -> (N, fy h, fx w) f32``:
the input read once, the output written once; a two-tap lerp along each
axis, 6 operations an output element, in f32."""
from benchmark.roofline import numel

DEVICE_NAMES = ("upsample_int",)


def cost(shapes, dtypes, scalars):
    fy, fx = int(scalars[1]), int(scalars[2])
    n_in = numel(shapes[0])
    return 4 * n_in * (1 + fy * fx), 6.0 * n_in * fy * fx, "float32"
