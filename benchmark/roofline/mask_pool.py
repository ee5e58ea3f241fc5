"""K1, ``poly::mask_pool(mask_logits (B, N, h, w), feats (B, h, w, C), thr)
-> (B, N, C) f32``: the logits and features read once, the pooled rows
written once; 2 B N h w C operations.  One operand is a 0/1 mask, exact in
bf16, so the product runs at the bf16 peak whatever the features' dtype."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("mask_pool",)


def cost(shapes, dtypes, scalars):
    (b, n, h, w), (_, _, _, c) = shapes[0], shapes[1]
    total = nbytes(shapes[0], dtypes[0]) + nbytes(shapes[1], dtypes[1]) + b * n * c * 4
    return total, 2.0 * b * n * h * w * c, "bfloat16"
