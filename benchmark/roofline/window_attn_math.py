"""K7, ``poly::window_attn_math(qkv (nw, L, 3C), bias (h, L, L) f32, mask
(ntypes, L, L) f32 or None, num_heads) -> (nw, L, C)``: qkv, the bias and
the mask read once, the output written once; Q K^T and P V, 4 nw L^2 C
operations in qkv's dtype (the softmax, 5 an entry, is left out: it runs
beside the products)."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("window_attn",)


def cost(shapes, dtypes, scalars):
    nw, l, c3 = shapes[0]
    c = c3 // 3
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:3], dtypes[:3]) if s)
    return ins + nbytes((nw, l, c), dtypes[0]), 4.0 * nw * l * l * c, dtypes[0]
