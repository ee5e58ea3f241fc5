"""ViTDet attention with the decomposed relative-position term, K10:
per window (or the whole image) and head,
``softmax((q * scale) k^T + rel_h + rel_w) v`` with
``rel_h[i, kr] = q_i . R_h[hq_i - kr + kh - 1]`` and
``rel_w[i, kc] = q_i . R_w[wq_i - kc + kw - 1]`` taken with the unscaled q
(detectron2 ``modeling/backbone/utils.py::add_decomposed_rel_pos``).

Replaces no Pallas kernel: the JAX package has no ViT.  It was added for
ViTDet ViT-L (``models/vit.py``), whose window blocks attend over 14 x 14 =
196 tokens and whose global blocks over the whole 64 x 128 grid of a
1024 x 2048 frame (8,192 tokens), both with a bias that depends on the
query, so neither K7/K8 (64 tokens, a query-independent bias table) nor a
materialised bias (2 GiB a frame per global block in bf16) will do.

One op, ``poly::relpos_attention(qkv (B, Hp, Wp, 3C), rel_pos_h (2 kh - 1,
hd), rel_pos_w (2 kw - 1, hd), num_heads, ws) -> (B, Hp, Wp, C)``: with
``ws > 0`` the ws x ws windows of the padded image, read and written in
place (kh = kw = ws); with ``ws = 0`` the whole image (kh = Hp, kw = Wp).
The tables come resized to 2k - 1 rows (``models/vit.py::get_rel_pos``) in
qkv's dtype.  A CUDA tensor launches ``csrc/relpos_attn.cu`` (bf16 only;
the source note gives the bound and design); a CPU tensor takes
:func:`relpos_attention_plain`, the same function in f32 torch ops with P
rounded to qkv's dtype before P V, computed in query chunks so that no
more than ``_CHUNK_ELEMS`` scores are held.  There is no backward kernel:
:func:`relpos_attention` raises in the backward of a CUDA call (serving
only; a CPU call differentiates the plain version).
"""
from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_relpos_attention", [
    _lib.P, _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32, _lib.I32,
    _lib.I32, _lib.F32])

HEAD_DIM = 64  # the kernel's head dim
# csrc/relpos_attn.cu: queries of a block, keys of a tile, bf16 elements of a
# shared row, rows of the K/V buffers (which also stage table rows)
BLOCK_Q, BLOCK_K, PITCH, KV_ROWS = 64, 64, 72, 256
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_CHUNK_ELEMS = 1 << 26  # scores the plain version holds at once


def _scale(hd: int) -> float:
    return float(hd) ** -0.5


def _geometry(hp: int, wp: int, ws: int) -> tuple[int, int]:
    """(kh, kw): the key rows and columns of a window (ws > 0) or image."""
    return (ws, ws) if ws else (hp, wp)


def rowtile(kw: int, ws: int) -> bool:
    """Whether the kernel runs a global call column half by column half (kw
    a multiple of BLOCK_K): each block's queries then lie in one image row."""
    return ws == 0 and kw % BLOCK_K == 0


def staged_rows(kh: int, kw: int, ws: int) -> int:
    """The most table rows a block of BLOCK_Q queries stages at its start
    (each table's part rounded up to 8): R_h rows hq_min .. hq_max + kh - 1
    and R_w rows wq_min .. wq_max + kw - 1 of its queries; R_h alone where
    :func:`rowtile` (each column half stages 128 rows of R_w later).  The
    kernel takes at most KV_ROWS."""
    most, l = 0, kh * kw
    for q0 in range(0, l, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, l) - 1
        h0, h1 = q0 // kw, q1 // kw
        w0, w1 = (q0 % kw, q1 % kw) if h0 == h1 else (0, kw - 1)
        rows = -(-(h1 - h0 + kh) // 8) * 8
        if not rowtile(kw, ws):
            rows += -(-(w1 - w0 + kw) // 8) * 8
        most = max(most, rows)
    return most


def smem_bytes(kh: int, kw: int, ws: int) -> int:
    """Shared memory of a block, as the kernel lays it out: the Q tile and
    the K/V buffers in bf16 rows of PITCH, and the f32 rel tables of pitch
    kh | 1 and (but where :func:`rowtile`) kw | 1."""
    return ((BLOCK_Q + KV_ROWS) * PITCH * 2
            + 4 * BLOCK_Q * ((kh | 1) + (0 if rowtile(kw, ws) else kw | 1)))


def _rel_index(k: int, device) -> torch.Tensor:
    """idx[i, j] = i - j + k - 1: the table row of query coordinate i and key
    coordinate j."""
    r = torch.arange(k, device=device)
    return r[:, None] - r[None, :] + (k - 1)


def _attend(q, k, v, rel_pos_h, rel_pos_w, kh: int, kw: int, p_dtype) -> torch.Tensor:
    """q, k, v (n, L, h, hd) f32 with L = kh * kw tokens in row-major order;
    returns (n, L, h * hd) f32, P rounded to ``p_dtype`` before P V."""
    n, l, h, hd = q.shape
    rh = rel_pos_h.float()[_rel_index(kh, q.device)]  # (kh, kh, hd)
    rw = rel_pos_w.float()[_rel_index(kw, q.device)]  # (kw, kw, hd)
    rows = max(1, min(kh, _CHUNK_ELEMS // max(1, n * h * l * kw)))
    out = q.new_empty((n, l, h, hd))
    for y0 in range(0, kh, rows):
        y1 = min(kh, y0 + rows)
        qc = q[:, y0 * kw:y1 * kw]
        attn = torch.einsum("nqhd,nkhd->nhqk", qc * _scale(hd), k)
        r = qc.reshape(n, y1 - y0, kw, h, hd)
        rel_h = torch.einsum("nyxhd,ykd->nhyxk", r, rh[y0:y1])
        rel_w = torch.einsum("nyxhd,xkd->nhyxk", r, rw)
        attn = (attn.view(n, h, y1 - y0, kw, kh, kw) + rel_h[..., :, None]
                + rel_w[..., None, :]).view(n, h, (y1 - y0) * kw, l)
        p = torch.softmax(attn, dim=-1).to(p_dtype).float()
        out[:, y0 * kw:y1 * kw] = torch.einsum("nhqk,nkhd->nqhd", p, v)
    return out.reshape(n, l, h * hd)


def relpos_attention_plain(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, num_heads: int, ws: int) -> torch.Tensor:
    """K10's arithmetic on (B, Hp, Wp, 3C): f32 scores from qkv's values,
    the rel terms from the unscaled q, an f32 softmax, P rounded to qkv's
    dtype, P V in f32, the output in qkv's dtype."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    kh, kw = _geometry(hp, wp, ws)
    x = qkv.float()
    if ws:
        x = x.reshape(b, hp // ws, ws, wp // ws, ws, c3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(-1, kh * kw, c3)
    q, k, v = (x[..., i * c:(i + 1) * c].reshape(*x.shape[:2], num_heads, c // num_heads)
               for i in range(3))
    out = _attend(q, k, v, rel_pos_h, rel_pos_w, kh, kw, qkv.dtype)
    if ws:
        out = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hp, wp, c).to(qkv.dtype)


def _check(qkv, rel_pos_h, rel_pos_w, num_heads: int, ws: int) -> tuple[int, int, int]:
    """Raise unless the op takes these tensors; returns (C, kh, kw)."""
    if qkv.dim() != 4:
        raise ValueError(f"qkv: expected (B, Hp, Wp, 3C), got {tuple(qkv.shape)}")
    b, hp, wp, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"qkv width {c3} is not 3 x heads x head dim ({num_heads} heads)")
    c = c3 // 3
    if ws < 0 or (ws and (hp % ws or wp % ws)):
        raise ValueError(f"qkv: {hp}x{wp} is not a multiple of the window {ws}")
    kh, kw = _geometry(hp, wp, ws)
    hd = c // num_heads
    for name, t, k in (("rel_pos_h", rel_pos_h, kh), ("rel_pos_w", rel_pos_w, kw)):
        if tuple(t.shape) != (2 * k - 1, hd):
            raise ValueError(f"{name} {tuple(t.shape)}, expected ({2 * k - 1}, {hd})")
        if t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, qkv {qkv.dtype} on "
                             f"{qkv.device}")
    return c, kh, kw


def _relpos_attention_cuda(qkv, rel_pos_h, rel_pos_w, num_heads: int, ws: int):
    c, kh, kw = _check(qkv, rel_pos_h, rel_pos_w, num_heads, ws)
    _lib.check_cuda("qkv", qkv, (torch.bfloat16,))
    for name, t in (("rel_pos_h", rel_pos_h), ("rel_pos_w", rel_pos_w)):
        _lib.check_cuda(name, t, (torch.bfloat16,), ndim=2)
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"head dim {c // num_heads}: the kernel takes {HEAD_DIM}")
    if staged_rows(kh, kw, ws) > KV_ROWS or smem_bytes(kh, kw, ws) > SMEM_LIMIT:
        raise ValueError(f"a {kh}x{kw} attention stages {staged_rows(kh, kw, ws)} table rows "
                         f"and needs {smem_bytes(kh, kw, ws)} bytes of shared memory a block: "
                         f"the kernel takes {KV_ROWS} and {SMEM_LIMIT}")
    for name, t in (("qkv", qkv), ("rel_pos_h", rel_pos_h), ("rel_pos_w", rel_pos_w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    b, hp, wp, _ = qkv.shape
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL.launch(qkv.data_ptr(), rel_pos_h.data_ptr(), rel_pos_w.data_ptr(), out.data_ptr(),
                  b, hp, wp, c, num_heads, ws, _scale(HEAD_DIM))
    return out


def _relpos_attention_cpu(qkv, rel_pos_h, rel_pos_w, num_heads: int, ws: int):
    _check(qkv, rel_pos_h, rel_pos_w, num_heads, ws)
    return relpos_attention_plain(qkv, rel_pos_h, rel_pos_w, num_heads, ws)


relpos_attention_op = _lib.define_op(
    "relpos_attention",
    "(Tensor qkv, Tensor rel_pos_h, Tensor rel_pos_w, int num_heads, int ws) -> Tensor",
    cpu=_relpos_attention_cpu, cuda=lambda *args: _relpos_attention_cuda(*args),
    fake=lambda qkv, *_: qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3)))


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rel_pos_h, rel_pos_w, num_heads: int, ws: int):
        ctx.save_for_backward(qkv, rel_pos_h, rel_pos_w)
        ctx.shape = (num_heads, ws)
        return relpos_attention_op(qkv, rel_pos_h, rel_pos_w, num_heads, ws)

    @staticmethod
    def backward(ctx, g):
        qkv, rel_pos_h, rel_pos_w = ctx.saved_tensors
        if qkv.is_cuda:
            raise NotImplementedError("poly::relpos_attention has no backward kernel "
                                      "(K10 serves only)")
        heads, ws = ctx.shape
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = relpos_attention_plain(*leaves, heads, ws)
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)


def relpos_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                     num_heads: int, ws: int) -> torch.Tensor:
    """K10.  qkv (B, Hp, Wp, 3C); rel_pos_h (2 kh - 1, hd) and rel_pos_w
    (2 kw - 1, hd) in qkv's dtype, with kh = kw = ws for windows of ``ws``
    (Hp and Wp multiples of it) or kh = Hp, kw = Wp for ``ws = 0`` (global).
    Returns (B, Hp, Wp, C) in qkv's dtype."""
    return _RelposAttention.apply(qkv, rel_pos_h, rel_pos_w, num_heads, ws)
