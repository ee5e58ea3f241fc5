"""Swin window attention, K7 and K8: per window and head,
``softmax(Q K^T * scale + bias (+ mask)) V`` over ws*ws tokens.

- K7, :func:`window_attn_math`, replaces
  ``polyphonicformer_tpu/ops/pallas/win_attn_math.py::_fwd_call``: windows
  already partitioned, qkv (nw, L, 3C), window w takes ``mask[w % ntypes]``,
  the f32 probabilities rounded to qkv's dtype before P V.
- K8, :func:`window_attention`, replaces
  ``polyphonicformer_tpu/ops/pallas/window_attn.py::_window_attention_fwd``:
  the padded image itself, qkv (B, Hp, Wp, 3C), the kernel gathering each
  window's rows from the image and writing them back in place; qkv upcast
  to f32 first, the probabilities kept in f32, one cast at the end.

Both CUDA kernels are ``csrc/window_attn.cu`` (the source note there gives
the bound and design: for bf16 qkv both products on the tensor cores, f32
qkv on the CUDA cores).  A CUDA tensor launches the kernel; a CPU tensor
takes the plain version beside it, the same function in f32 PyTorch ops.
Each entry point is a ``torch.autograd.Function`` on either device: the
forward is the kernel (or the plain version), the backward the VJP of the
plain version recomputed from the saved inputs, as the JAX package's
custom VJPs differentiate their jnp formulations (``_wam_bwd``,
``_wa_bwd``).  So no backward kernel exists, and none is needed.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _lib

KERNEL_MATH = _lib.Kernel("poly_window_attn_math", [
    _lib.P, _lib.I32, _lib.P, _lib.P, _lib.P, _lib.I64, _lib.I32, _lib.I32, _lib.I32,
    _lib.I32, _lib.F32, _lib.I32, _lib.I32, _lib.I32, _lib.I32])
KERNEL_IMAGE = _lib.Kernel("poly_window_attention", [
    _lib.P, _lib.I32, _lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32,
    _lib.I32, _lib.I32, _lib.F32, _lib.I32, _lib.I32, _lib.I32, _lib.I32])

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_L = 64  # tokens per window (csrc/window_attn.cu: 8 key tiles, two softmax columns a lane)
_MAX_HD = 64  # head dim (shared memory of one block)
GROUP_CHANNELS = 64  # channels of a bf16 block (head dims rounded up to 16)
MAX_WARPS = 8  # warps of a bf16 block, one per (head, 16-row query strip)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the bf16 kernel: ``group`` heads per block, shared rows
    of ``pitch`` bf16 elements, ``smem`` bytes and ``warps`` warps a block,
    ``grid`` (windows, head groups)."""
    group: int
    pitch: int
    smem: int
    warps: int
    grid: tuple[int, int]


def launch_plan(nwin: int, heads: int, hd: int, l: int, masked: bool) -> Plan:
    """The bf16 kernel's launch for ``nwin`` windows of ``l`` tokens and
    ``heads`` heads of ``hd``: the most heads per block that divide
    ``heads`` within GROUP_CHANNELS channels and MAX_WARPS warps (at least
    one).  A head takes a slot of hd rounded up to 16 channels; a row of the
    Q, K and V tiles is the group's slots and 8 elements more (16 bytes, so
    the 8 rows of an ldmatrix fall in distinct banks).  Shared memory: the
    three tiles of 64 rows, the group's f32 bias tiles, the f32 mask tile,
    64 floats a warp (``csrc/window_attn.cu::mma_smem``)."""
    hd16 = -(-hd // 16) * 16
    strips = -(-l // 16)
    group = max(g for g in range(1, heads + 1) if heads % g == 0 and (
        g == 1 or (g * hd16 <= GROUP_CHANNELS and g * strips <= MAX_WARPS)))
    pitch = group * hd16 + 8
    warps = group * strips
    smem = 3 * 64 * pitch * 2 + 4 * group * l * l + (4 * l * l if masked else 0) + 4 * 64 * warps
    return Plan(group, pitch, smem, warps, (nwin, heads // group))


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def _attend(q, k, v, bias, mask, p_dtype) -> torch.Tensor:
    """q, k, v (nw, L, h, hd) f32; bias (h, L, L); mask (ntypes, L, L) with
    window w taking ``mask[w % ntypes]``, or None.  Returns (nw, L, h*hd)
    f32; the probabilities are rounded to ``p_dtype`` before P V."""
    nw, l, h, hd = q.shape
    attn = torch.einsum("wqhd,wkhd->whqk", q, k) * _scale(hd)
    attn = attn + bias[None]
    if mask is not None:
        nt = mask.shape[0]
        attn = (attn.reshape(nw // nt, nt, h, l, l) + mask[None, :, None]).reshape(nw, h, l, l)
    p = torch.softmax(attn, dim=-1).to(p_dtype).float()
    return torch.einsum("whqk,wkhd->wqhd", p, v).reshape(nw, l, h * hd)


def _split_heads(x: torch.Tensor, num_heads: int):
    """(nw, L, 3C) -> q, k, v each (nw, L, h, hd) f32."""
    nw, l, c3 = x.shape
    c = c3 // 3
    return [x[..., i * c:(i + 1) * c].reshape(nw, l, num_heads, c // num_heads).float()
            for i in range(3)]


def window_attn_math_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                           num_heads: int) -> torch.Tensor:
    """K7's arithmetic: Q K^T accumulated in f32 from qkv's dtype, * scale,
    + bias, + mask, f32 softmax, P rounded to qkv's dtype, P V in f32, the
    output in qkv's dtype."""
    q, k, v = _split_heads(qkv, num_heads)
    return _attend(q, k, v, bias.float(), None if mask is None else mask.float(),
                   qkv.dtype).to(qkv.dtype)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                           num_heads: int, ws: int) -> torch.Tensor:
    """K8's arithmetic on (B, Hp, Wp, 3C): qkv upcast to f32, the windows
    regrouped, P kept in f32, one cast at the end.  mask (Hp/ws * Wp/ws, L,
    L) is the same for every image."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    x = qkv.float().reshape(b, hp // ws, ws, wp // ws, ws, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = _split_heads(x.reshape(-1, ws * ws, c3), num_heads)
    out = _attend(q, k, v, bias.float(), None if mask is None else mask.float(), torch.float32)
    out = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hp, wp, c).to(qkv.dtype)


def _check(qkv, bias, mask, num_heads: int, l: int, ntypes_ok) -> tuple[int, int]:
    """Raise unless the kernels take these tensors; returns (C, ntypes)."""
    _lib.check_cuda("qkv", qkv, _DTYPES)
    c3 = qkv.shape[-1]
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"qkv width {c3} is not 3 x heads x head dim ({num_heads} heads)")
    c = c3 // 3
    if l > _MAX_L or c // num_heads > _MAX_HD:
        raise ValueError(f"window of {l} tokens, head dim {c // num_heads}: the kernel takes "
                         f"at most {_MAX_L} and {_MAX_HD}")
    _lib.check_cuda("bias", bias, (torch.float32,), ndim=3)
    if bias.shape != (num_heads, l, l) or bias.device != qkv.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device}, expected "
                         f"({num_heads}, {l}, {l}) on {qkv.device}")
    if mask is None:
        return c, 1
    _lib.check_cuda("mask", mask, (torch.float32,), ndim=3)
    if mask.shape[1:] != (l, l) or not ntypes_ok(mask.shape[0]) or mask.device != qkv.device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} does not fit qkv "
                         f"{tuple(qkv.shape)}")
    return c, mask.shape[0]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _plan_args(qkv, nwin: int, num_heads: int, c: int, l: int, masked: bool) -> tuple:
    """(group, pitch, smem, vec) of the bf16 launch, vec: 16-byte loads and
    stores (head dim and C multiples of 8, qkv 16-byte aligned); unused for
    f32."""
    if qkv.dtype != torch.bfloat16:
        return 0, 0, 0, 0
    hd = c // num_heads
    plan = launch_plan(nwin, num_heads, hd, l, masked)
    vec = hd % 8 == 0 and c % 8 == 0 and qkv.data_ptr() % 16 == 0
    return plan.group, plan.pitch, plan.smem, int(vec)


def _window_attn_math_fwd(qkv, bias, mask, num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return window_attn_math_plain(qkv, bias, mask, num_heads)
    if qkv.dim() != 3:
        raise ValueError(f"qkv: expected (nw, L, 3C), got {tuple(qkv.shape)}")
    nw, l, _ = qkv.shape
    c, ntypes = _check(qkv, bias, mask, num_heads, l, lambda n: n > 0 and nw % n == 0)
    out = torch.empty((nw, l, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL_MATH.launch(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), bias.data_ptr(),
                       _ptr(mask), out.data_ptr(), nw, l, c, num_heads, ntypes,
                       _scale(c // num_heads),
                       *_plan_args(qkv, nw, num_heads, c, l, mask is not None))
    return out


def _window_attention_fwd(qkv, bias, mask, num_heads: int, ws: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, num_heads, ws)
    if qkv.dim() != 4:
        raise ValueError(f"qkv: expected (B, Hp, Wp, 3C), got {tuple(qkv.shape)}")
    b, hp, wp, _ = qkv.shape
    if hp % ws or wp % ws:
        raise ValueError(f"qkv: {hp}x{wp} is not a multiple of the window {ws}")
    per_image = (hp // ws) * (wp // ws)
    l = ws * ws
    c, _ = _check(qkv, bias, mask, num_heads, l, lambda n: n == per_image)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    KERNEL_IMAGE.launch(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), bias.data_ptr(),
                        _ptr(mask), out.data_ptr(), b, hp, wp, c, num_heads, ws,
                        _scale(c // num_heads),
                        *_plan_args(qkv, b * per_image, num_heads, c, l, mask is not None))
    return out


def _plain_vjp(plain, inputs, needs, g: torch.Tensor) -> tuple:
    """The gradients of ``plain(*inputs)`` for the inputs flagged in
    ``needs`` (None for the others), recomputed under autograd."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        wrt = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(plain(*leaves), wrt, g))
    return tuple(next(grads) if need else None for need in needs)


class _WindowAttnMath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads: int):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.num_heads = num_heads
        return _window_attn_math_fwd(qkv, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, g):
        heads = ctx.num_heads
        return (*_plain_vjp(lambda q, b, m: window_attn_math_plain(q, b, m, heads),
                            ctx.saved_tensors, ctx.needs_input_grad[:3], g), None)


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads: int, ws: int):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.shape = (num_heads, ws)
        return _window_attention_fwd(qkv, bias, mask, num_heads, ws)

    @staticmethod
    def backward(ctx, g):
        heads, ws = ctx.shape
        return (*_plain_vjp(lambda q, b, m: window_attention_plain(q, b, m, heads, ws),
                            ctx.saved_tensors, ctx.needs_input_grad[:3], g), None, None)


def window_attn_math(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                     num_heads: int) -> torch.Tensor:
    """K7.  qkv (nw, L, 3C) f32 or bf16; bias (heads, L, L) f32; mask
    (ntypes, L, L) f32 with nw a multiple of ntypes, or None.  Returns (nw,
    L, C) in qkv's dtype, differentiable in qkv, bias and mask."""
    return _WindowAttnMath.apply(qkv, bias, mask, num_heads)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
                     num_heads: int, ws: int) -> torch.Tensor:
    """K8.  qkv (B, Hp, Wp, 3C) f32 or bf16 with Hp and Wp multiples of
    ``ws``; bias (heads, ws*ws, ws*ws) f32; mask (Hp/ws * Wp/ws, ws*ws,
    ws*ws) f32, the same for every image, or None.  Returns (B, Hp, Wp, C)
    in qkv's dtype, differentiable in qkv, bias and mask."""
    return _WindowAttention.apply(qkv, bias, mask, num_heads, ws)
