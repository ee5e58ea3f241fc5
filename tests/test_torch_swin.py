"""The port's Swin backbone and the plain versions of its two
window-attention kernels against the JAX package, on the CPU.

Inputs and weights are drawn from seeded numpy generators and handed to both
sides; the JAX side takes the port's weights through the JAX package's own
converter (``convert_torch_ckpt``).  The JAX kernels run in interpret mode.

- K7 plain (``window_attn_math_plain``) against JAX ``window_attn_math``:
  70 windows (not a multiple of JAX's 64-window block), a mask of 35 window
  types (two images), f32 and bf16.
- K8 plain (``window_attention_plain``) against JAX
  ``window_attention_pallas``: two 14x63 images (63 is not a multiple of
  JAX's 56-column tile), f32 and bf16.
- ``SwinTransformer`` with stage 0 at 2 heads (K8) and stage 1 at 16 heads
  (K7), two 60x100 images (padding at both stages): against JAX's default
  XLA path and against JAX with both kernels switched on
  (``POLY_FUSED_WATTN=interpret``, ``POLY_WATTN_MATH=interpret``), each in
  f32 and bf16.  JAX's bf16 XLA path rounds Q K^T to bf16 before the scale
  and P to bf16 at every stage, where the port's K8 keeps P in f32.
- The whole model on ``swin_tiny`` at the debug widths, 64x128, f32.

Tolerances.  f32: sums in another order, |port - jax| <= 1e-5 (kernels,
outputs of magnitude ~3; measured 1e-6), <= 1e-5 x max |jax| (backbone;
measured 6e-7) and <= 1e-4 x max |jax| (model).  bf16
kernels, in units of the bf16 spacing (ulp) at the output: the output is
rounded once, so a rounding may flip, and K8 lies within one ulp everywhere
(measured: 1).  K7 also rounds each p to bf16 before P V; where the two
sides' f32 p straddle a rounding point, that p moves by its ulp (at most
2^-8 for p < 1) and the output by at most 2^-8 max |v|.  Such flips are
rare: at most 1e-3 of K7's outputs may lie beyond one ulp (measured 4e-5),
none beyond one ulp + 2^-8 max |v|.  K8's arithmetic, P kept in f32, puts
11% of K7's outputs beyond one ulp and fails this bound
(``test_k7_bound_needs_rounded_p``).  bf16 backbone: both sides round after every op in bf16, and an
ulp flipped early grows through the blocks: max |port - jax| <= 0.03 x max
|jax| and the mean <= 0.005 x max |jax| (measured when written: 0.012 and
0.0018 on the last level).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.models.swin import SwinTransformer as JaxSwin
from polyphonicformer_tpu.ops.pallas.win_attn_math import window_attn_math as jax_k7
from polyphonicformer_tpu.ops.pallas.window_attn import window_attention_pallas as jax_k8
from polyphonicformer_tpu.tools import convert_torch_ckpt as jax_ckpt
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.models.swin import (SwinTransformer, _shift_attn_mask,
                                                window_partition, window_unpartition)
from polyphonicformer_torch.ops.cuda.window_attn import window_attention, window_attn_math
from polyphonicformer_torch.weights import to_numpy_state_dict

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
K7_FLIPS = 1e-3  # share of K7's bf16 outputs allowed beyond one ulp


def _attn_inputs(seed, lead, c3, heads, l, mask_hw):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(*lead, c3).astype(np.float32)
    bias = (rng.randn(heads, l, l) * 0.5).astype(np.float32)
    mask = None if mask_hw is None else _shift_attn_mask(*mask_hw, 7, 3)
    return qkv, bias, mask


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x|: 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _attn_mismatch(want, got, v, dtype, rounds_p):
    """Why ``got`` is outside the module docstring's bound, or None."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if got.shape != want.shape:
        return f"shape {got.shape} != {want.shape}"
    err = np.abs(got - want)
    if dtype == "f32":
        return None if err.max() <= 1e-5 else f"max err {err.max()}"
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    beyond = float((err > ulp).mean())
    if not rounds_p:
        return None if beyond == 0 else f"{beyond:.2e} of the outputs beyond one ulp"
    if (err > ulp + 2.0 ** -8 * np.abs(v).max()).any() or beyond > K7_FLIPS:
        return f"{beyond:.2e} of the outputs beyond one ulp, max err {err.max()}"
    return None


def _k7_inputs(masked):
    """70 windows of 2 heads x 16 (two 35x49 images of 35 windows each)."""
    heads, hd, l = 2, 16, 49
    qkv, bias, mask = _attn_inputs(0, (70, l), 3 * heads * hd, heads, l,
                                   (35, 49) if masked else None)
    return qkv, bias, mask, heads, qkv[..., 2 * heads * hd:]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_k7_plain_matches_jax_kernel(dtype, masked):
    qkv, bias, mask, heads, v = _k7_inputs(masked)
    jdt, tdt = DTYPES[dtype]
    want = jax_k7(jnp.asarray(qkv, jdt), jnp.asarray(bias),
                  None if mask is None else jnp.asarray(mask), heads, True)
    got = window_attn_math(torch.from_numpy(qkv).to(tdt), torch.from_numpy(bias),
                           None if mask is None else torch.from_numpy(mask), heads)
    assert got.dtype == tdt
    assert _attn_mismatch(want, got, v, dtype, rounds_p=True) is None


@pytest.mark.parametrize("masked", [False, True])
def test_k7_bound_needs_rounded_p(masked):
    """K8's arithmetic (P kept in f32) on K7's bf16 inputs, laid out as the
    two images, is outside K7's bound against the JAX kernel."""
    qkv, bias, mask, heads, v = _k7_inputs(masked)
    want = jax_k7(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
                  None if mask is None else jnp.asarray(mask), heads, True)
    image = window_unpartition(torch.from_numpy(qkv).to(torch.bfloat16), 7, (35, 49))
    unrounded = window_partition(window_attention(
        image, torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
        heads, 7), 7)
    assert _attn_mismatch(want, unrounded, v, "bf16", rounds_p=True) is not None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_k8_plain_matches_jax_kernel(dtype, masked):
    heads, hd, ws = 3, 8, 7
    qkv, bias, mask = _attn_inputs(1, (2, 14, 63), 3 * heads * hd, heads, ws * ws,
                                   (14, 63) if masked else None)
    jdt, tdt = DTYPES[dtype]
    want = jax_k8(jnp.asarray(qkv, jdt), jnp.asarray(bias),
                  None if mask is None else jnp.asarray(mask), heads, ws, True)
    got = window_attention(torch.from_numpy(qkv).to(tdt), torch.from_numpy(bias),
                           None if mask is None else torch.from_numpy(mask), heads, ws)
    assert got.shape == (2, 14, 63, heads * hd) and got.dtype == tdt
    assert _attn_mismatch(want, got, qkv[..., 2 * heads * hd:], dtype, rounds_p=False) is None


def test_window_partition_roundtrip():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 14, 28, 8).astype(np.float32))
    w = window_partition(x, 7)
    assert w.shape == (2 * 2 * 4, 49, 8)
    assert torch.equal(window_unpartition(w, 7, (14, 28)), x)


DEPTHS, HEADS = (2, 2), (2, 16)  # stage 0 -> K8 (<= 12 heads), stage 1 -> K7


def _port_swin(seed=0):
    """The small backbone with every parameter drawn from numpy: weights at
    1/sqrt(fan_in), norm scales 1 +- 0.1, biases at 0.1, bias tables at 0.5."""
    model = SwinTransformer(32, DEPTHS, HEADS)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if name.endswith("relative_position_bias_table"):
                v = rng.randn(*shape) * 0.5
            elif p.dim() == 1:
                is_scale = name.endswith("weight")
                v = (1.0 if is_scale else 0.0) + 0.1 * rng.randn(*shape)
            else:
                v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model.eval()


def _jax_swin_variables(model):
    """The port's weights in the JAX layout, through the JAX converter."""
    sd = {f"backbone.{k}": v.numpy() for k, v in model.state_dict().items()}
    flat = {path[len("backbone/"):]: jax_ckpt._transform(sd[key], kind)
            for path, (key, kind) in jax_ckpt._swin_mapping(DEPTHS).items()}
    return {"params": jax_ckpt.unflatten_tree(flat)}


@pytest.mark.parametrize("path", ["xla_f32", "kernels_f32", "kernels_bf16", "xla_bf16"])
def test_swin_backbone_matches_jax(path, monkeypatch):
    kernels = path.startswith("kernels")
    monkeypatch.setenv("POLY_FUSED_WATTN", "interpret" if kernels else "0")
    monkeypatch.setenv("POLY_WATTN_MATH", "interpret" if kernels else "xla")
    dtype = path.rsplit("_", 1)[1]
    jdt, tdt = DTYPES[dtype]
    port = _port_swin()
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _jax_swin_variables(port))
    x = np.random.RandomState(3).randn(2, 60, 100, 3).astype(np.float32)
    want = JaxSwin(32, DEPTHS, HEADS).apply(variables, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = port.to(tdt)(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for level, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)
        b = b.float().numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        err, scale = np.abs(a - b), np.abs(a).max()
        if dtype == "f32":
            assert err.max() <= 1e-5 * scale, (level, err.max(), scale)
        else:
            assert err.max() <= 0.03 * scale and err.mean() <= 0.005 * scale, \
                (level, err.max(), err.mean(), scale)


def test_swin_tiny_model_matches_jax():
    """The whole model on swin_tiny at the debug widths, f32, against the
    JAX package's default path: every output of the rpn head and stages."""
    jcfg = dataclasses.replace(get_preset("debug_tiny").model, backbone="swin_tiny")
    port = build_model(model_preset("debug_tiny", backbone="swin_tiny"), "cpu",
                       generator=torch.Generator().manual_seed(0))
    variables = jax_ckpt.convert_state_dict(to_numpy_state_dict(port), jcfg)
    img = np.random.RandomState(4).randn(1, 64, 128, 3).astype(np.float32)
    want = JaxModel(jcfg).apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    pairs = [("rpn.mask_preds", want.rpn.mask_preds, got.rpn.mask_preds)]
    for s, (a, b) in enumerate(zip(want.stages, got.stages)):
        pairs += [(f"stage{s}.{f}", getattr(a, f), getattr(b, f))
                  for f in ("cls_score", "mask_preds", "depth_preds")]
    for name, a, b in pairs:
        a, b = np.asarray(a, np.float32), b.numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= 1e-4 * np.abs(a).max(), (name, err, np.abs(a).max())
