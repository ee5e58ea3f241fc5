"""The port's serving path against the JAX package's, end to end on the
CPU: ``video_frame_step`` over 3 frames, ``clip_video_step``, the image
step, the tracker and the candidate order.

Widths of ``debug_tiny_video`` with ``max_per_img=100``, so the bf16 path's
prune fold (``fusion_full_things=53``) is exercised; frames 64x128.  One set
of weights, drawn for the port from a seeded ``torch.Generator`` and bridged
to JAX with ``convert_state_dict``; each side takes its own package's
configuration of the preset.  The last stage's ``fc_cls`` bias is 0 on
both sides so that thing scores straddle ``instance_score_thr`` and things
are kept and tracked.  The frames are one image of 16-pixel colour blocks
plus small noise per frame (numpy, seeded), so a kept thing persists and
keeps its track id.

Measured when these tests were written: the semantic, panoptic and track
maps agree exactly on both fusion dtypes, and the tracker ids and
``num_tracklets`` are equal.  The asserts hold looser bounds: maps on
>= 99.9% of pixels, depth
where the maps agree within rtol 1e-4 + atol 2e-3 in f32 (depth spans 80 m
and the f32 network differs by ~1e-5 relative), and within one bf16 ulp
(rtol 2^-7) on the bf16 fusion, whose depth is stored in bf16.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.infer import pipeline as jpipe
from polyphonicformer_tpu.infer.panoptic import segments_info_host as jax_segments_info_host
from polyphonicformer_tpu.infer.tracker import init_tracker_state as jax_init_state
from polyphonicformer_tpu.infer.tracker import tracker_step as jax_tracker_step
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools.convert_torch_ckpt import convert_state_dict
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.infer.panoptic import segments_info_host, top_k
from polyphonicformer_torch.infer.tracker import init_tracker_state, tracker_step
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.weights import to_numpy_state_dict

H, W = 64, 128
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    pcfg = model_preset("debug_tiny_video", max_per_img=100)
    port = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.roi_head.mask_head[-1].fc_cls.bias.zero_()
    variables = convert_state_dict(to_numpy_state_dict(port), cfg)
    return cfg, pcfg, port, JaxModel(cfg), variables


def _frames(n=3):
    rng = np.random.RandomState(0)
    base = np.repeat(np.repeat(rng.randn(1, H // 16, W // 16, 3) * 2, 16, 1), 16, 2)
    return [(base + 0.1 * rng.randn(1, H, W, 3)).astype(np.float32) for _ in range(n)]


def _agree(name, jax_map, port_map):
    a, b = np.asarray(jax_map), port_map.numpy()
    assert a.shape == b.shape, name
    frac = (a == b).mean()
    assert frac >= 0.999, (name, frac)
    return a == b


def _depth_close(jax_depth, port_depth, where, rtol, atol):
    a, b = np.asarray(jax_depth)[where], port_depth.numpy()[where]
    assert (np.abs(a - b) <= atol + rtol * np.abs(a)).all(), np.abs(a - b).max()


@pytest.mark.parametrize("fusion", ["f32", "bf16"])
def test_video_frame_step_matches_jax(models, fusion, monkeypatch):
    """(a) compute f32, fusion f32; (b) compute f32, fusion bf16 with the
    JAX side's Pallas kernels interpreted (POLY_PALLAS_FUSION=interpret)."""
    cfg, pcfg, port, jm, variables = models
    if fusion == "bf16":
        monkeypatch.setenv("POLY_PALLAS_FUSION", "interpret")
    jdt, tdt = DTYPES[fusion]
    step = jpipe.make_video_step(jm, cfg, (H, W), fusion_dtype=jdt)
    js = jax_init_state(cfg.tracker, cfg.track_head.embed_channels)
    ps = init_tracker_state(pcfg.tracker, pcfg.track_head.embed_channels, "cpu")
    rtol, atol = (1e-4, 2e-3) if fusion == "f32" else (2.0 ** -7, 2e-3)
    tracked = 0
    for t, img in enumerate(_frames()):
        fj, js = step(variables, jnp.asarray(img), js, jnp.int32(t + 1))
        fp, ps = pipeline.video_frame_step(port, pcfg, torch.from_numpy(img), ps, t + 1,
                                           (H, W), fusion_dtype=tdt)
        same = _agree("semantic", fj.semantic, fp.semantic)
        same &= _agree("panoptic", fj.panoptic, fp.panoptic)
        same &= _agree("track_map", fj.track_map, fp.track_map)
        _depth_close(fj.depth, fp.depth, same, rtol, atol)
        np.testing.assert_array_equal(np.asarray(js.ids), ps.ids.numpy())
        assert int(js.num_tracklets) == int(ps.num_tracklets)
        assert int(fj.track_overflow) == int(fp.track_overflow)
        tracked += int((fp.track_map > 0).any())
    assert tracked == 3, "a thing must be kept and tracked in every frame"


def test_clip_video_step_matches_jax(models):
    """The clip loop (f32) against the JAX lax.scan clip program."""
    cfg, pcfg, port, jm, variables = models
    imgs = np.concatenate(_frames())
    step = jpipe.make_clip_step(jm, cfg, (H, W))
    out_j, js = step(variables, jnp.asarray(imgs),
                     jax_init_state(cfg.tracker, cfg.track_head.embed_channels), jnp.int32(1))
    out_p, ps = pipeline.make_clip_step(port, pcfg, (H, W))(
        torch.from_numpy(imgs), init_tracker_state(pcfg.tracker, pcfg.track_head.embed_channels, "cpu"), 1)
    same = _agree("semantic", out_j.semantic, out_p.semantic)
    same &= _agree("track_map", out_j.track_map, out_p.track_map)
    same &= _agree("panoptic", out_j.panoptic, out_p.panoptic)
    _depth_close(out_j.depth, out_p.depth, same, 1e-4, 2e-3)
    assert out_p.semantic.shape == (3, H, W) and out_p.semantic.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(js.ids), ps.ids.numpy())


@pytest.mark.parametrize("fusion", ["f32", "bf16"])
def test_image_step_matches_jax(models, fusion, monkeypatch):
    cfg, pcfg, port, jm, variables = models
    if fusion == "bf16":
        monkeypatch.setenv("POLY_PALLAS_FUSION", "interpret")
    jdt, tdt = DTYPES[fusion]
    img = _frames(1)[0]
    pj = jpipe.make_image_step(jm, cfg, (H, W), fusion_dtype=jdt)(variables, jnp.asarray(img))
    pp = pipeline.make_image_step(port, pcfg, (H, W), fusion_dtype=tdt)(torch.from_numpy(img))
    same = _agree("semantic", pj.semantic, pp.semantic) & _agree("panoptic", pj.panoptic,
                                                                  pp.panoptic)
    rtol = 1e-4 if fusion == "f32" else 2.0 ** -7
    _depth_close(pj.depth, pp.depth, same, rtol, 2e-3)
    np.testing.assert_array_equal(np.asarray(pj.keep), pp.keep.numpy())
    np.testing.assert_array_equal(np.asarray(pj.seg_ids), pp.seg_ids.numpy())
    # segments_info: same segments in the same order; scores to f32 noise
    info_j = jax_segments_info_host(pj, cfg.num_thing_classes)
    info_p = segments_info_host(pp, pcfg.num_thing_classes)
    assert [{k: v for k, v in e.items() if k != "score"} for e in info_j] == \
        [{k: v for k, v in e.items() if k != "score"} for e in info_p]
    for a, b in zip(info_j, info_p):
        assert abs(a.get("score", 0.0) - b.get("score", 0.0)) <= 1e-5
    assert info_p, "no segment kept"


def test_top_k_order_matches_lax_top_k():
    """Candidate order with ties: index order among equal scores."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 6, size=160).astype(np.float32) / 8
    vj, ij = jax.lax.top_k(jnp.asarray(x), 100)
    vp, ip = top_k(torch.from_numpy(x), 100)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vp.numpy())


def test_tracker_step_matches_jax_with_ties():
    """Four frames of detections with tied scores and invalid rows (whose
    -inf sort keys tie); a stable sort and the greedy loop must give the
    JAX state, ids, order and kept mask exactly."""
    tc, pc = get_preset("debug_tiny_video").model.tracker, model_preset("debug_tiny_video").tracker
    e, d = 8, tc.max_detections
    rng = np.random.RandomState(0)
    base = rng.rand(d, 2) * 200
    emb_base = rng.randn(d, e).astype(np.float32)
    js = jax_init_state(tc, e)
    ps = init_tracker_state(pc, e, "cpu")
    for f in range(4):
        xy = base + rng.randn(d, 2)
        boxes = np.concatenate([xy, xy + 30, np.round(rng.rand(d, 1) * 4) / 4 * 0.8 + 0.1],
                               axis=1).astype(np.float32)
        labels = rng.randint(0, 3, d).astype(np.int32)
        emb = (emb_base + 0.05 * rng.randn(d, e)).astype(np.float32)
        valid = rng.rand(d) > 0.4
        jout = jax_tracker_step(tc, js, *map(jnp.asarray, (boxes, labels, emb, valid)),
                                jnp.int32(f + 1))
        pout = tracker_step(pc, ps, *map(torch.from_numpy, (boxes, labels, emb, valid)),
                            torch.tensor(f + 1, dtype=torch.int32))
        js, ps = jout[0], pout[0]
        for a, b in zip(jout[1:], pout[1:]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for field in ("ids", "labels", "last_frame", "acc_frames", "bd_valid", "bd_labels"):
            np.testing.assert_array_equal(np.asarray(getattr(js, field)),
                                          getattr(ps, field).numpy(), err_msg=field)
        for field in ("embeds", "bboxes", "velocities", "bd_embeds"):
            np.testing.assert_allclose(np.asarray(getattr(js, field)),
                                       getattr(ps, field).numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=field)
        assert int(js.num_tracklets) == int(ps.num_tracklets)
    assert int(ps.num_tracklets) > 0 and (ps.ids >= 0).any()
