"""Multi-clip serving: the port's ``batched_video_step`` against the JAX
package's on the CPU, B = 2 clips x 2 frames, f32.

Widths of ``debug_tiny_video`` with ``max_per_img=100``, frames 64x128; one
set of weights drawn for the port from a seeded ``torch.Generator`` and
bridged to JAX with ``convert_state_dict``; the last stage's ``fc_cls`` bias
is 0 so that things are kept and tracked.  Each clip is its own image of
16-pixel colour blocks plus small noise per frame (numpy, seeded), and the
two clips run at different frame ids, so a tracker state shared between
clips would show.  Asserted: the semantic, panoptic and track maps equal
on >= 99.9% of pixels (measured when written: all of them), depth where
they agree within rtol 1e-4 + atol 2e-3 (as ``test_torch_slice.py``),
every field of each clip's tracker state equal (ids, counts) or within
1e-5; and each clip of the batched step agrees with the one-clip
``video_frame_step`` on that clip (maps on >= 99.9% of pixels: a batch of
2 may sum the convolutions in another order; tracker ids equal).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.infer import pipeline as jpipe
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools.convert_torch_ckpt import convert_state_dict
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.infer.tracker import init_tracker_state
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.weights import to_numpy_state_dict

H, W, B = 64, 128, 2
INT_FIELDS = ("ids", "labels", "last_frame", "acc_frames", "num_tracklets", "bd_valid",
              "bd_labels")
FLOAT_FIELDS = ("embeds", "bboxes", "velocities", "bd_embeds", "bd_bboxes")


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    pcfg = model_preset("debug_tiny_video", max_per_img=100)
    port = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.roi_head.mask_head[-1].fc_cls.bias.zero_()
    return cfg, pcfg, port, JaxModel(cfg), convert_state_dict(to_numpy_state_dict(port), cfg)


def _clips(frames=2):
    """(frames, B, H, W, 3): each clip its own seed's colour blocks plus
    noise (seeds whose scenes keep a thing with these weights)."""
    out = np.zeros((frames, B, H, W, 3), np.float32)
    for b, seed in enumerate((0, 3)):
        rng = np.random.RandomState(seed)
        base = np.repeat(np.repeat(rng.randn(H // 16, W // 16, 3) * 2, 16, 0), 16, 1)
        for t in range(frames):
            out[t, b] = base + 0.1 * rng.randn(H, W, 3)
    return out


def test_batched_video_step_matches_jax(models):
    cfg, pcfg, port, jm, variables = models
    jstep = jpipe.make_batched_video_step(jm, cfg, (H, W))
    pstep = pipeline.make_batched_video_step(port, pcfg, (H, W))
    js = jpipe.init_batched_tracker_states(cfg, B)
    ps = pipeline.init_batched_tracker_states(pcfg, B, "cpu")
    tracked = 0
    for t, imgs in enumerate(_clips()):
        fids = np.array([t + 1, t + 10], np.int32)
        fj, js = jstep(variables, jnp.asarray(imgs), js, jnp.asarray(fids))
        fp, ps = pstep(torch.from_numpy(imgs), ps, torch.from_numpy(fids))
        same = np.ones((B, H, W), bool)
        for name in ("semantic", "panoptic", "track_map"):
            a, b = np.asarray(getattr(fj, name)), getattr(fp, name).numpy()
            assert a.shape == b.shape == (B, H, W), name
            assert (a == b).mean() >= 0.999, (name, (a == b).mean())
            same &= a == b
        a, b = np.asarray(fj.depth)[same], fp.depth.numpy()[same]
        assert (np.abs(a - b) <= 2e-3 + 1e-4 * np.abs(a)).all()
        np.testing.assert_array_equal(np.asarray(fj.track_overflow), fp.track_overflow.numpy())
        for name in INT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                          getattr(ps, name).numpy(), err_msg=name)
        for name in FLOAT_FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(js, name)), getattr(ps, name).numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        tracked += int((fp.track_map > 0).flatten(1).any(1).sum())
    assert tracked == 2 * B, "each clip must keep and track a thing in every frame"


def test_batched_step_equals_one_clip_steps(models):
    """Clip b of the batched step is ``video_frame_step`` on clip b alone."""
    _, pcfg, port, _, _ = models
    clips = torch.from_numpy(_clips())
    ps = pipeline.init_batched_tracker_states(pcfg, B, "cpu")
    singles = [init_tracker_state(pcfg.tracker, pcfg.track_head.embed_channels, "cpu")
               for _ in range(B)]
    for t in range(clips.shape[0]):
        fp, ps = pipeline.batched_video_step(port, pcfg, clips[t], ps, [t + 1, t + 10], (H, W))
        for b in range(B):
            fo, singles[b] = pipeline.video_frame_step(port, pcfg, clips[t, b:b + 1],
                                                       singles[b], t + 1 + 9 * b, (H, W))
            for name in ("semantic", "panoptic", "track_map"):
                agree = (getattr(fp, name)[b] == getattr(fo, name)).float().mean()
                assert agree >= 0.999, (t, b, name, float(agree))
            assert torch.equal(ps.ids[b], singles[b].ids)
