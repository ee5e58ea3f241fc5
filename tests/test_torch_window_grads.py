"""The gradients of the port's window-attention entry points (K7
``window_attn_math``, K8 ``window_attention``) against the JAX package's
custom VJPs, on the CPU.

Both sides differentiate a plain recompute: JAX's ``_wam_bwd`` /
``_wa_bwd`` take the VJP of their jnp formulations, the port's autograd
Functions the VJP of the plain versions.  The JAX forwards run in interpret
mode.  Inputs and the output cotangent come from seeded numpy generators,
f32, with the shift mask and without: 2 heads of head dim 8, window 4 (16
tokens), two 8x12 images (6 windows each).

Tolerance: |port - jax| <= 1e-5 x max |jax| for each gradient (f32 sums in
another order; JAX scales by 1/sqrt(hd) as a divide, the port as a
multiply).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.ops.pallas.win_attn_math import window_attn_math as jax_k7
from polyphonicformer_tpu.ops.pallas.window_attn import window_attention_pallas as jax_k8
from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition
from polyphonicformer_torch.ops.cuda.window_attn import window_attention, window_attn_math

HEADS, HD, WS, B, HP, WP = 2, 8, 4, 2, 8, 12
L = WS * WS
RTOL = 1e-5


def _inputs(seed: int, masked: bool):
    """qkv as the two images (B, HP, WP, 3C), bias, mask or None, and a
    cotangent of the output's shape."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, HP, WP, 3 * HEADS * HD).astype(np.float32)
    bias = (rng.randn(HEADS, L, L) * 0.5).astype(np.float32)
    mask = _shift_attn_mask(HP, WP, WS, WS // 2) if masked else None
    g = rng.randn(B, HP, WP, HEADS * HD).astype(np.float32)
    return qkv, bias, mask, g


def _torch_grads(fn, qkv, bias, mask, g):
    """Gradients of sum(fn(...) * g) for qkv, bias and (if given) mask."""
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (qkv, bias) + (() if mask is None else (mask,))]
    out = fn(leaves[0], leaves[1], leaves[2] if mask is not None else None)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in leaves]


def _close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert scale > 0 and err <= RTOL * scale, (i, err, scale)


@pytest.mark.parametrize("masked", [False, True])
def test_k7_grads_match_jax(masked):
    """K7 on the partitioned windows of the two images: mask window types
    6, so window w takes mask[w % 6]."""
    qkv, bias, mask, g = _inputs(0, masked)
    part = lambda a: window_partition(torch.from_numpy(a), WS).numpy()  # noqa: E731
    win, gw = part(qkv), part(g)
    args = [jnp.asarray(a) for a in (win, bias) + (() if mask is None else (mask,))]
    if mask is None:
        _, vjp = jax.vjp(lambda q, b: jax_k7(q, b, None, HEADS, True), *args)
    else:
        _, vjp = jax.vjp(lambda q, b, m: jax_k7(q, b, m, HEADS, True), *args)
    want = vjp(jnp.asarray(gw))
    got = _torch_grads(lambda q, b, m: window_attn_math(q, b, m, HEADS), win, bias, mask, gw)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_k8_grads_match_jax(masked):
    qkv, bias, mask, g = _inputs(1, masked)
    args = [jnp.asarray(a) for a in (qkv, bias) + (() if mask is None else (mask,))]
    if mask is None:
        _, vjp = jax.vjp(lambda q, b: jax_k8(q, b, None, HEADS, WS, True), *args)
    else:
        _, vjp = jax.vjp(lambda q, b, m: jax_k8(q, b, m, HEADS, WS, True), *args)
    want = vjp(jnp.asarray(g))
    got = _torch_grads(lambda q, b, m: window_attention(q, b, m, HEADS, WS), qkv, bias, mask, g)
    _close(got, want)


@pytest.mark.parametrize("entry", ["k7", "k8"])
def test_grads_only_where_asked(entry):
    """With only the bias requiring a gradient, the bias gets the same
    gradient and qkv and the mask get none."""
    qkv, bias, mask, g = _inputs(2, True)
    if entry == "k7":
        qkv, g = (window_partition(torch.from_numpy(a), WS).numpy() for a in (qkv, g))
        fn = lambda q, b, m: window_attn_math(q, b, m, HEADS)  # noqa: E731
    else:
        fn = lambda q, b, m: window_attention(q, b, m, HEADS, WS)  # noqa: E731
    full = _torch_grads(fn, qkv, bias, mask, g)
    q, b, m = torch.from_numpy(qkv), torch.from_numpy(bias).requires_grad_(True), \
        torch.from_numpy(mask)
    fn(q, b, m).backward(torch.from_numpy(g))
    assert q.grad is None and m.grad is None
    assert np.array_equal(b.grad.numpy(), full[1])
