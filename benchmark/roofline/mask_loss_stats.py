"""K6, ``poly::mask_loss_stats(m, t (N, Q, H, W) f32, pos (N, Q), valid (N,
H, W), lbl (N, H, W) i32) -> stats (N, 2), dice (N, 3, Q), lse (N, H, W)``:
the inputs read once, the sums and the logsumexp written once.  Per
element: sigmoid and softplus from one exponential (4), the BCE term (4),
three dice products and sums (6), the logsumexp step (4): 18, in f32."""
from benchmark.roofline import nbytes, numel

DEVICE_NAMES = ("mask_loss",)


def cost(shapes, dtypes, scalars):
    n, q, h, w = shapes[0]
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:5], dtypes[:5]))
    outs = 4 * (n * 2 + n * 3 * q + n * h * w)
    return ins + outs, 18.0 * numel(shapes[0]), "float32"
