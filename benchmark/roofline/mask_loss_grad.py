"""K6b, ``poly::mask_loss_grad(m, t (N, Q, H, W), pos, valid, lbl, gstats,
gdice, lse) -> dm (N, Q, H, W) f32``: the inputs read once, the gradient
written once.  Per element: the sigmoid (3), the BCE and dice terms (8), the
softmax term from the saved logsumexp (4): 15, in f32."""
from benchmark.roofline import nbytes, numel

DEVICE_NAMES = ("mask_loss",)


def cost(shapes, dtypes, scalars):
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:8], dtypes[:8]))
    return ins + 4 * numel(shapes[0]), 15.0 * numel(shapes[0]), "float32"
