"""ViTDet's backbone and pyramid (``models/vit.py``) and K10's plain version
(``ops/cuda/relpos_attn.py``) against the plain reference
(``tests/vitdet_reference.py``, detectron2's equations with the bias
materialised), on the CPU at a tiny size: embed 64, depth 4 with global
blocks 1 and 3, 2 heads of 32, windows of 3 on a 4 x 8 grid (not a
multiple of 3, so the window blocks pad), seeded weights handed to both
sides as one state dict.

Tolerances, each with its reason:
* f32: the port and the reference run the same operations in another
  order (a fused layer norm against detectron2's mean and variance; the
  rel terms added per chunk of query rows): relative L2 gaps of ~1e-6 were
  measured, so 1e-5 holds them with room;
* bf16 (the op alone): the plain version rounds P to bf16 before P V and
  its output once to bf16, 2^-9 relative each, which the f32 reference does
  not: ~2.3e-3 was measured, 1e-2 holds it.
Each check is repeated with the rel-pos term dropped on one side, and
that gap must lie far above the tolerance (0.35-0.9 were measured).
"""
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from polyphonicformer_torch.configs import VIT_SPECS, model_preset
from polyphonicformer_torch.infer.pipeline import (init_batched_tracker_states,
                                                   make_batched_video_step)
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.ops.cuda import relpos_attn
from polyphonicformer_torch.tools import flops

sys.path.insert(0, str(Path(__file__).resolve().parent))
import vitdet_reference as ref  # noqa: E402

torch.set_num_threads(2)
F32_TOL, BF16_TOL = 1e-5, 1e-2
HEADS, HD = 2, 32


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def reference_attention(qkv, rel_pos_h, rel_pos_w, heads: int, ws: int) -> torch.Tensor:
    """The reference's ``Attention`` after ``qkv`` (f32), over the windows
    of the padded image (``ws > 0``) or the whole of it."""
    b, hp, wp, _ = qkv.shape
    x = qkv.float()
    if ws:
        x, _ = ref.window_partition(x, ws)
    n, h, w, _ = x.shape
    q, k, v = x.reshape(n, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4).reshape(
        3, n * heads, h * w, -1).unbind(0)
    attn = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1)
    attn = ref.add_decomposed_rel_pos(attn, q, rel_pos_h.float(), rel_pos_w.float(), (h, w),
                                      (h, w))
    out = (attn.softmax(-1) @ v).view(n, heads, h, w, -1).permute(0, 2, 3, 1, 4)
    out = out.reshape(n, h, w, -1)
    return ref.window_unpartition(out, ws, (hp, wp), (hp, wp)) if ws else out


def attention_inputs(hp: int, wp: int, ws: int, dtype, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    kh, kw = (ws, ws) if ws else (hp, wp)
    qkv = torch.randn(2, hp, wp, 3 * HEADS * HD, generator=g)
    rh = torch.randn(2 * kh - 1, HD, generator=g) * 0.3
    rw = torch.randn(2 * kw - 1, HD, generator=g) * 0.3
    return qkv.to(dtype), rh.to(dtype), rw.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hp,wp,ws", [(6, 9, 3), (4, 8, 0)], ids=["window", "global"])
def test_op_plain_matches_reference_attention(hp, wp, ws, dtype, tol):
    qkv, rh, rw = attention_inputs(hp, wp, ws, dtype)
    want = reference_attention(qkv, rh, rw, HEADS, ws)
    got = relpos_attn.relpos_attention_op(qkv, rh, rw, HEADS, ws)
    assert got.dtype == dtype and got.shape == (2, hp, wp, HEADS * HD)
    assert rel(got, want) <= tol
    dropped = relpos_attn.relpos_attention_op(qkv, rh * 0, rw * 0, HEADS, ws)
    assert rel(dropped, want) > 20 * tol


def test_op_chunks_queries_as_one_pass(monkeypatch):
    """The plain version's query chunks give what one chunk gives."""
    qkv, rh, rw = attention_inputs(4, 8, 0, torch.float32)
    whole = relpos_attn.relpos_attention_plain(qkv, rh, rw, HEADS, 0)
    monkeypatch.setattr(relpos_attn, "_CHUNK_ELEMS", 1)
    assert torch.allclose(relpos_attn.relpos_attention_plain(qkv, rh, rw, HEADS, 0), whole,
                          rtol=1e-6, atol=1e-6)


def test_op_checks_its_inputs():
    qkv, rh, rw = attention_inputs(6, 9, 3, torch.float32)
    with pytest.raises(ValueError, match="multiple of the window"):
        relpos_attn.relpos_attention_op(qkv[:, :5], rh, rw, HEADS, 3)
    with pytest.raises(ValueError, match="rel_pos_w"):
        relpos_attn._check(qkv, rh, rw[:-1], HEADS, 3)
    with pytest.raises(ValueError, match="rel_pos_h"):
        relpos_attn._check(qkv, rh.bfloat16(), rw, HEADS, 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        relpos_attn._relpos_attention_cuda(qkv.bfloat16(), rh.bfloat16(), rw.bfloat16(),
                                           HEADS, 3)


@pytest.mark.parametrize("kh,kw,ws,rows,smem", [(14, 14, 14, 56, 53760),
                                                (64, 128, 0, 64, 62720), (3, 3, 3, 16, 47616)])
def test_staged_rows(kh, kw, ws, rows, smem):
    """The table rows a kernel block stages and its shared memory at ViT-L's
    window and global shapes: 4 window blocks or 3 global blocks an SM."""
    assert relpos_attn.staged_rows(kh, kw, ws) == rows <= relpos_attn.KV_ROWS
    assert relpos_attn.smem_bytes(kh, kw, ws) == smem


def test_backward_of_a_cpu_call_is_the_plain_vjp():
    qkv, rh, rw = attention_inputs(6, 9, 3, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (qkv, rh, rw)]
    relpos_attn.relpos_attention(*leaves, HEADS, 3).square().sum().backward()
    plain = [t.clone().requires_grad_() for t in (qkv, rh, rw)]
    relpos_attn.relpos_attention_plain(*plain, HEADS, 3).square().sum().backward()
    for a, b in zip(leaves, plain):
        assert torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def _tiny_model(seed: int = 0):
    cfg = model_preset("debug_tiny_video", backbone="vitdet_tiny", max_per_img=100)
    return cfg, build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))


def _reference_of(model, with_rel_pos: bool = True) -> ref.Backbone:
    embed, depth, heads, global_blocks, window = VIT_SPECS["vitdet_tiny"]
    out = ref.Backbone(embed, depth, heads, global_blocks, window,
                       model.cfg.fpn_out_channels, with_rel_pos)
    out.load_state_dict({k: v for k, v in model.state_dict().items()
                         if k.startswith(("backbone.", "neck."))}, strict=True)
    return out


def test_backbone_and_pyramid_match_reference():
    _, model = _tiny_model()
    x = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.neck(model.backbone(x))
        want = _reference_of(model)(x)
        dropped = _reference_of(model, with_rel_pos=False)(x)
    assert [tuple(t.shape) for t in got] == [(2, 64, 16, 32), (2, 64, 8, 16), (2, 64, 4, 8),
                                             (2, 64, 2, 4)]
    for g, w, d in zip(got, want, dropped):
        assert rel(g, w) <= F32_TOL
        assert rel(g, d) > 1000 * F32_TOL


def test_blocks_hand_k10_contiguous_tables(monkeypatch):
    """The kernel takes contiguous tables: the resized R_w of a global block
    (a transposed interpolation) is made contiguous."""
    from polyphonicformer_torch.models import vit

    _, model = _tiny_model()
    seen = []

    def spy(qkv, rh, rw, heads, ws):
        seen.append((ws, tuple(rh.shape), tuple(rw.shape),
                     qkv.is_contiguous() and rh.is_contiguous() and rw.is_contiguous()))
        return relpos_attn.relpos_attention(qkv, rh, rw, heads, ws)

    monkeypatch.setattr(vit, "relpos_attention", spy)
    with torch.no_grad():
        model.backbone(torch.zeros(1, 3, 64, 128))
    assert seen == [(3, (5, HD), (5, HD), True), (0, (7, HD), (15, HD), True)] * 2


def test_state_dict_keys_are_detectrons():
    cfg, model = _tiny_model()
    keys = set(model.state_dict())
    assert {"backbone.pos_embed", "backbone.patch_embed.proj.weight",
            "backbone.blocks.3.attn.rel_pos_w", "neck.simfp_2.1.weight",
            "neck.simfp_2.5.norm.bias", "neck.simfp_5.2.weight"} <= keys
    assert model.backbone.blocks[1].attn.rel_pos_h.shape == (127, HD)  # global: 1024 / 16
    assert model.backbone.blocks[0].attn.rel_pos_h.shape == (5, HD)  # window of 3
    with pytest.raises(ValueError, match="not tensor-sharded"):
        build_model(model_preset("debug_tiny_video", backbone="vitdet_tiny",
                                 shard_backbone=True), "cpu",
                    generator=torch.Generator().manual_seed(0))


def test_batched_video_step_on_the_tiny_vit():
    cfg, model = _tiny_model()
    hw = (64, 128)
    step = make_batched_video_step(model, cfg, hw)
    states = init_batched_tracker_states(cfg, 2, "cpu")
    g = torch.Generator().manual_seed(2)
    for t in range(2):
        out, states = step(torch.randn(2, *hw, 3, generator=g), states, [t, t])
    for name in ("semantic", "panoptic", "track_map", "depth"):
        x = getattr(out, name)
        assert x.shape == (2, *hw), name
        assert torch.isfinite(x.float()).all(), name


@pytest.mark.parametrize("hp,wp,ws", [(6, 9, 3), (4, 8, 0)], ids=["window", "global"])
def test_flop_formula_counts_the_reference_attention(hp, wp, ws):
    qkv, rh, rw = attention_inputs(hp, wp, ws, torch.float32)
    with FlopCounterMode(display=False) as counter:
        reference_attention(qkv, rh, rw, HEADS, ws)
    assert flops.relpos_attention_flop(tuple(qkv.shape), tuple(rh.shape), tuple(rw.shape),
                                       HEADS, ws) == counter.get_total_flops()
