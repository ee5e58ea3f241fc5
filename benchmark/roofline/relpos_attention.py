"""K10, ``poly::relpos_attention(qkv (B, Hp, Wp, 3C), rel_pos_h (2 kh - 1,
hd), rel_pos_w (2 kw - 1, hd), num_heads, ws) -> (B, Hp, Wp, C)``: per window
of ws x ws (kh = kw = ws) or over the whole image (ws = 0: kh = Hp, kw = Wp)
and head, Q K^T and P V (4 L^2 hd) and the rel terms q . R_h and q . R_w
(2 L (kh + kw) hd), L = kh kw; the bytes of qkv, both tables and the
output.  Its kernels are relpos_attn_window_kernel and
relpos_attn_global_kernel."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("relpos_attn",)


def cost(shapes, dtypes, scalars):
    b, hp, wp, c3 = shapes[0]
    ws = int(scalars[4])
    kh, kw = (ws, ws) if ws else (hp, wp)
    c, l = c3 // 3, kh * kw
    nw = b * hp * wp // l
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:3], dtypes[:3]))
    flops = 4.0 * nw * l * l * c + 2.0 * nw * l * (kh + kw) * c
    return ins + nbytes((b, hp, wp, c), dtypes[0]), flops, dtypes[0]
