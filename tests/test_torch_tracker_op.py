"""``poly::tracker_step`` (K9) on the CPU: its route is the plain tracker
looped over the clips, its fake outputs match the real ones, its wrapper
refuses what the kernel does not take, and the serving steps that call it
give what the per-clip tracker gave them before (bit for bit).  The kernel
itself is held to the plain version on the card in
``tests/test_torch_cuda_kernels.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.infer.tracker import TrackerState, tracker_step
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.ops.cuda import tracker as k9
import tracker_cases

torch.set_num_threads(2)

SMALL = dict(d=16, t=32, bd=32, e=8)  # two backdrop frames: the older block shifts


def _equal(got, want):
    """Lists of tensors bit-equal, dtypes and shapes included."""
    assert len(got) == len(want)
    for name, g, w in zip(k9.FIELDS + ("ids", "order", "kept"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def _fields(state):
    return [getattr(state, n) for n in k9.FIELDS]


def _flat(step):
    """(state, ids, order, kept) as one list."""
    return _fields(step[0]) + list(step[1:])


@pytest.mark.parametrize("seed", [6, 7, 8, 9, 10, 11, 14, 21])
def test_cpu_route_equals_clip_loop(seed):
    """Eight frames of 3 clips: the batched op against ``tracker_step`` on
    each clip with its own state, every output and state field bit-equal;
    the input state is left as it was and nothing is launched."""
    b = 3
    cfg, frames = tracker_cases.sequence(seed, b, **SMALL)
    batched = tracker_cases.fresh_states(cfg, b, SMALL["e"])
    clips = [batched.map(lambda x, i=i: x[i].clone()) for i in range(b)]
    launches = k9.KERNEL.launches
    for boxes, labels, emb, valid, fids in frames:
        before = batched.map(torch.clone)
        got = k9.tracker_step_batched(cfg, batched, boxes, labels, emb, valid, fids)
        _equal(_fields(batched), _fields(before))
        per_clip = [tracker_step(cfg, clips[i], boxes[i], labels[i], emb[i], valid[i], fids[i])
                    for i in range(b)]
        _equal(_flat(got), [torch.stack(x) for x in zip(*map(_flat, per_clip))])
        batched, clips = got[0], [p[0] for p in per_clip]
    assert k9.KERNEL.launches == launches


def test_fake_outputs_match_real():
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, frames = tracker_cases.sequence(9, 2, frames=1, **SMALL)
    state = tracker_cases.fresh_states(cfg, 2, SMALL["e"])
    real = _flat(k9.tracker_step_batched(cfg, state, *frames[0]))
    with FakeTensorMode() as mode:
        fake = _flat(k9.tracker_step_batched(cfg, state.map(mode.from_tensor),
                                             *map(mode.from_tensor, frames[0])))
    assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype) for r in real]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cfg, frames = tracker_cases.sequence(9, 2, frames=1, **SMALL)
    state = tracker_cases.fresh_states(cfg, 2, SMALL["e"])
    boxes, labels, emb, valid, fids = frames[0]
    step = k9.tracker_step_batched
    with pytest.raises(TypeError):  # int64 labels
        step(cfg, state, boxes, labels.long(), emb, valid, fids)
    with pytest.raises(TypeError):  # f64 state embeddings
        step(cfg, state.replace(embeds=state.embeds.double()), boxes, labels, emb, valid, fids)
    with pytest.raises(ValueError):  # one clip's rows without the clip axis
        step(cfg, state, boxes, labels, emb, valid[0], fids)
    with pytest.raises(ValueError):  # a state of another clip count
        step(cfg, state.map(lambda x: x[:1]), boxes, labels, emb, valid, fids)
    with pytest.raises(ValueError):  # more detections than tracklets
        step(cfg, state.map(lambda x: x[:, :8] if x.dim() > 1 and x.shape[1] == 32 else x),
             boxes, labels, emb, valid, fids)
    with pytest.raises(ValueError):
        step(dataclasses.replace(cfg, match_metric="l2"), state, boxes, labels, emb, valid, fids)
    with pytest.raises(ValueError, match="multiple of 4"):  # E = 6
        step(cfg, state.replace(embeds=state.embeds[..., :6].contiguous(),
                                bd_embeds=state.bd_embeds[..., :6].contiguous()),
             boxes, labels, emb[..., :6].contiguous(), valid, fids)
    # more memo columns than the greedy warp holds: T 256 and BD 32
    long_cfg = tracker_cases.config(9, d=16, t=256, bd=32)
    with pytest.raises(ValueError, match="T \\+ BD <= 256"):
        step(long_cfg, tracker_cases.fresh_states(long_cfg, 2, SMALL["e"]),
             boxes, labels, emb, valid, fids)
    # a shared-memory plan past 227 KB: D 64, T 128, BD 64 and E 1024
    big = tracker_cases.config(0)
    wide = tracker_cases.fresh_states(big, 1, 1024)
    assert k9.smem_bytes(64, 128, 64, 1024) > k9.SMEM_LIMIT >= k9.smem_bytes(64, 128, 64, 256)
    with pytest.raises(ValueError, match="shared memory"):
        step(big, wide, torch.zeros((1, 64, 5)), torch.zeros((1, 64), dtype=torch.int32),
             torch.zeros((1, 64, 1024)), torch.zeros((1, 64), dtype=torch.bool),
             torch.zeros(1, dtype=torch.int32))



@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    """The JAX package's ``tracker_step`` for the port's ``cfg``, jitted."""
    import jax

    from polyphonicformer_tpu.configs import TrackerConfig as JaxTrackerConfig
    from polyphonicformer_tpu.infer.tracker import tracker_step as jax_tracker_step

    names = {f.name for f in dataclasses.fields(JaxTrackerConfig)}
    jcfg = JaxTrackerConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})
    return jax.jit(lambda *args: jax_tracker_step(jcfg, *args))


@pytest.mark.parametrize("seed", range(48))
def test_cpu_route_matches_jax(seed):
    """The seeded hard cases (``tracker_cases``: every match metric,
    ``with_cats`` on and off, 0, 4, all or any rows valid, two embedding
    scales (the wider one matches more rows), tied scores,
    duplicated boxes and embeddings, a full table that overflows, expiry
    across gaps in the frame ids) over 8 frames of 2 clips: the CPU route
    of ``poly::tracker_step`` against the JAX package's ``tracker_step``
    on each clip.  Ids, order, kept and the integer state exactly; the
    float state within f32 rounding (rtol = atol = 1e-5)."""
    import jax.numpy as jnp

    from polyphonicformer_tpu.infer.tracker import TrackerState as JaxTrackerState

    b = 2
    cfg, frames = tracker_cases.sequence(seed, b, **SMALL)
    step = _jax_step(cfg)
    state = tracker_cases.fresh_states(cfg, b, SMALL["e"])
    jstates = [JaxTrackerState(*(jnp.asarray(getattr(state, n)[i].numpy()) for n in k9.FIELDS))
               for i in range(b)]
    for f, (boxes, labels, emb, valid, fids) in enumerate(frames):
        state, *outs = k9.tracker_step_batched(cfg, state, boxes, labels, emb, valid, fids)
        for i in range(b):
            jstate, *jouts = step(jstates[i], *(jnp.asarray(x[i].numpy())
                                               for x in (boxes, labels, emb, valid, fids)))
            for name, j, p in zip(("ids", "order", "kept"), jouts, outs):
                np.testing.assert_array_equal(np.asarray(j), p[i].numpy(),
                                              err_msg=f"frame {f} clip {i} {name}")
            for name in k9.FIELDS:
                j, p = np.asarray(getattr(jstate, name)), getattr(state, name)[i].numpy()
                if p.dtype == np.float32:
                    np.testing.assert_allclose(j, p, rtol=1e-5, atol=1e-5,
                                               err_msg=f"frame {f} clip {i} {name}")
                else:
                    np.testing.assert_array_equal(j, p, err_msg=f"frame {f} clip {i} {name}")
            jstates[i] = jstate
    if seed // 6 % 4 == 2:  # every row valid: the table overflowed
        assert int(state.num_tracklets.max()) > SMALL["t"]


# --- the serving steps against the per-clip tracker they called before ---

H, W, B = 64, 128, 2


def _per_clip_track_and_render(cfg, pano, det, embeds, tracker_state, frame_id):
    """One clip's tracker step and maps as the serving steps made them
    before ``poly::tracker_step``: the plain tracker on this clip alone."""
    d = cfg.tracker.max_detections
    kk = pano.instance_ids.shape[0]
    take = min(d, kk)
    new_state, ids_sorted, order, kept_sorted = tracker_step(
        cfg.tracker, tracker_state, det.boxes, det.labels, embeds, det.valid, frame_id)
    ids_by_det = torch.zeros((d,), dtype=torch.int32)
    ids_by_det[order] = torch.where(kept_sorted & (ids_sorted >= 0), ids_sorted + 1,
                                    torch.zeros_like(ids_sorted))
    overflow = (det.thing_keep.sum() - det.thing_keep[:take].sum()).to(torch.int32)
    cand_track_id = torch.zeros((kk,), dtype=torch.int32)
    cand_track_id[:take] = ids_by_det[:take]
    ids_full = cand_track_id * det.thing_keep.to(torch.int32)
    nr = kk if pano.n_render is None else pano.n_render
    semantic, panoptic, depth, track_map = pipeline.render_maps(
        pano.pix_arg, pano.depth_pix, pano.depth_basic, pano.labels[:nr], pano.seg_ids[:nr],
        pano.keep[:nr], ids_full[:nr], cfg.num_classes)
    pano = pano._replace(semantic=semantic, panoptic=panoptic, depth=depth)
    return pipeline.FrameOutput(semantic=semantic, track_map=track_map, depth=depth,
                                depth_basic=pano.depth_basic, panoptic=panoptic, pano=pano,
                                track_overflow=overflow), new_state


def _per_clip_step(model, cfg, images, states, frame_ids, fusion_dtype):
    """``batched_video_step`` as it was: the tracker and the maps per clip."""
    model, fpn, heads = pipeline._heads(model, images, torch.float32)
    panos = [pipeline._fuse(cfg, heads, b, (H, W), fusion_dtype, emit_marginals=True,
                            defer_maps=True) for b in range(B)]
    dets = [pipeline._detections(cfg, pano) for pano in panos]
    embeds = model.forward_track_embeds(fpn, None, torch.stack([d.valid for d in dets]),
                                        boxes=torch.stack([d.roi_boxes for d in dets])).float()
    outs, new = zip(*(
        _per_clip_track_and_render(cfg, panos[b], dets[b], embeds[b],
                                   states.map(lambda x, b=b: x[b]),
                                   torch.tensor(frame_ids[b], dtype=torch.int32))
        for b in range(B)))
    return pipeline._stack(list(outs)), pipeline._stack(list(new))


@pytest.fixture(scope="module")
def port():
    cfg = model_preset("debug_tiny_video", max_per_img=100)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    return cfg, model


def _clips(frames=3):
    out = np.zeros((frames, B, H, W, 3), np.float32)
    for b, seed in enumerate((0, 3)):
        rng = np.random.RandomState(seed)
        base = np.repeat(np.repeat(rng.randn(H // 16, W // 16, 3) * 2, 16, 0), 16, 1)
        for t in range(frames):
            out[t, b] = base + 0.1 * rng.randn(H, W, 3)
    return torch.from_numpy(out)


def _leaves(tree):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


@pytest.mark.parametrize("fusion", [torch.float32, torch.bfloat16])
def test_batched_step_bit_equal_to_per_clip_path(port, fusion):
    """Three frames of 2 clips at debug widths: every output (maps, fusion
    results, overflow) and every state field of ``batched_video_step``
    bit-equal to the per-clip path."""
    cfg, model = port
    clips = _clips()
    got_s = want_s = pipeline.init_batched_tracker_states(cfg, B, "cpu")
    tracked = 0
    for t in range(clips.shape[0]):
        fids = [t + 1, t + 10]
        got, got_s = pipeline.batched_video_step(model, cfg, clips[t], got_s, fids, (H, W),
                                                 fusion_dtype=fusion)
        with torch.no_grad():
            want, want_s = _per_clip_step(model, cfg, clips[t], want_s, fids, fusion)
        g, w = _leaves(got), _leaves(want)
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        _equal(_fields(got_s), _fields(want_s))
        tracked += int((got.track_map > 0).flatten(1).any(1).sum())
    assert tracked == 3 * B, "each clip must keep and track a thing in every frame"
    assert isinstance(got_s, TrackerState)
