"""K8, ``poly::window_attention(qkv (B, Hp, Wp, 3C), bias (h, L, L), mask
(nW, L, L) or None, num_heads, ws) -> (B, Hp, Wp, C)``: as K7 over the B Hp
Wp / ws^2 windows of the image layout, L = ws^2."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("window_attn",)


def cost(shapes, dtypes, scalars):
    b, hp, wp, c3 = shapes[0]
    ws = int(scalars[4])
    c, l = c3 // 3, ws * ws
    nw = b * (hp // ws) * (wp // ws)
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:3], dtypes[:3]) if s)
    return ins + nbytes((b, hp, wp, c), dtypes[0]), 4.0 * nw * l * l * c, dtypes[0]
