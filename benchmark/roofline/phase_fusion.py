"""K3, ``poly::phase_fusion(probs (K, hs, ws), scores (K,), depth (K, hs,
ws), fy, fx, n_full) -> pix (H, W) i32, dep (H, W) f32, counts (kf (H + W +
1),) f32``: the candidate maps read once and the outputs written once.
Operations: every candidate's probability at every full-resolution pixel
(a separable two-tap lerp, 6, times its score, 1, and the running maximum,
1), the winner's depth (6 a pixel) and its counts (3 a pixel), in f32."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("phase_fusion",)


def cost(shapes, dtypes, scalars):
    k, hs, ws = shapes[0]
    fy, fx = int(scalars[3]), int(scalars[4])
    n_full = scalars[5]
    kpad = (k + 7) // 8 * 8
    nf = kpad if n_full is None else min((int(n_full) + 7) // 8 * 8, kpad)
    kf = min(nf, k)
    h, w = hs * fy, ws * fx
    total = (nbytes(shapes[0], dtypes[0]) + nbytes(shapes[1], dtypes[1])
             + nbytes(shapes[2], dtypes[2]) + 8 * h * w + 4 * kf * (h + w + 1))
    return total, (8.0 * k + 9.0) * h * w, "float32"
