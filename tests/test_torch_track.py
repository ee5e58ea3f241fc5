"""The port's track losses, GT track boxes and separable RoIAlign against
the JAX package's, on the CPU, from seeded numpy inputs.

* ``multi_pos_cross_entropy`` and ``l2_aux_loss``: values within rtol 1e-5
  of ``jax.value_and_grad``'s, each gradient within 1e-4 of its largest
  magnitude; cases with padded rows and columns, a row without positives,
  the hard-mining cap active and inactive, and exact ties at the cap.
* ``track_pair_losses``: values and gradients, same bounds.
* ``upsampled_support_marginals``: bit-equal to JAX and to the counts of
  the materialised binarised upsample, at factors 2 and 4 on the mask
  cases of ``tests/test_track_boxes.py``; in the port, ``gt_track_boxes``
  equals ``masks_to_boxes_mad(gt_track_masks(...))`` bit for bit.  The
  boxes against JAX's: the centres are exact integer sums over the area,
  but the mean absolute deviations are f32 sums of non-integer terms that
  XLA and torch add in other orders (up to 128 ulps of a coordinate where
  x1 = cx - 2 dx cancels), so they are held at the JAX package's own
  tolerance for boxes, rtol 1e-5 and atol 1e-4
  (``tests/test_track_boxes.py``).
* ``multilevel_roi_align_separable`` within 1e-4 of JAX's (and of the
  port's gather form); the track head's masks form equal to its boxes form.

JAX runs eagerly here (no jit), so the file compiles no JAX program.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.losses import track as jax_track
from polyphonicformer_tpu.ops import roi_align as jax_roi
from polyphonicformer_tpu.ops.resize import resize_bilinear as jax_resize
from polyphonicformer_tpu.train import video_losses as jax_video
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.data.structures import GTSample
from polyphonicformer_torch.losses import track
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.ops import roi_align
from polyphonicformer_torch.train import video_losses


def _mask_cases():
    """The mask cases of tests/test_track_boxes.py::_cases, copied."""
    rng = np.random.RandomState(0)
    h, w = 32, 48
    cases = []
    for d in (0.98, 0.85, 0.5):
        cases.append((rng.rand(5, h, w) * (rng.rand(5, h, w) > d)).astype(np.float32))
    m = np.zeros((8, h, w), np.float32)
    m[1] = 1.0
    m[2, 0, 0] = 0.3
    m[3, h - 1, w - 1] = 1.0
    m[4, 0, w - 1] = 0.7
    m[5, h - 1, 0] = 1.0
    m[6, 0, :] = 1.0
    m[7, :, 0] = 1.0
    cases.append(m)
    m2 = np.zeros((2, h, w), np.float32)
    m2[0, 3:5, 4:8] = 1.0
    m2[0, 3:5, 20:23] = 1.0
    m2[1, 10, ::7] = 1.0
    cases.append(m2)
    return cases


def _pair_case(name):
    """(pred, target, pair_valid, row_valid) numpy inputs of one case; pred
    in [-0.2, 1.2] so the aux loss's clip is exercised."""
    rng = np.random.RandomState(["padded", "no_pos_row", "cap_active", "cap_inactive",
                                 "cap_ties"].index(name))
    k, r = 10, 12
    pred = rng.uniform(-0.2, 1.2, (k, r)).astype(np.float32)
    row_valid = np.ones(k, bool)
    col_valid = np.ones(r, bool)
    target = (rng.rand(k, r) < 0.15).astype(np.int32)
    if name == "padded":
        row_valid[7:] = False
        col_valid[9:] = False
    elif name == "no_pos_row":
        target[2] = 0
        target[5] = 0
    elif name == "cap_active":  # one positive a row: 9+ negatives each
        target = np.zeros((k, r), np.int32)
        target[np.arange(k), rng.randint(0, r, k)] = 1
    elif name == "cap_inactive":  # mostly positives
        target = (rng.rand(k, r) < 0.6).astype(np.int32)
    elif name == "cap_ties":  # costs from 3 values: many exact ties at the cap
        target = np.zeros((k, r), np.int32)
        target[np.arange(k), np.arange(k)] = 1
        pred = rng.choice(np.float32([0.35, 0.6, 0.85]), (k, r)).astype(np.float32)
    pair_valid = row_valid[:, None] & col_valid[None, :]
    return pred, target, pair_valid, row_valid


CASES = ["padded", "no_pos_row", "cap_active", "cap_inactive", "cap_ties"]


def _check_value_and_grad(jax_fn, port_fn, pred):
    want, gwant = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = port_fn(x)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    gwant = np.asarray(gwant)
    assert np.abs(x.grad.numpy() - gwant).max() <= 1e-4 * np.abs(gwant).max() + 1e-12


@pytest.mark.parametrize("case", CASES)
def test_multi_pos_cross_entropy_matches_jax(case):
    pred, target, pv, rv = _pair_case(case)
    t, pvt, rvt = (torch.from_numpy(a) for a in (target, pv, rv))
    _check_value_and_grad(
        lambda p: jax_track.multi_pos_cross_entropy(p, jnp.asarray(target), jnp.asarray(pv),
                                                    jnp.asarray(rv)),
        lambda p: track.multi_pos_cross_entropy(p, t, pvt, rvt), pred * 4)


@pytest.mark.parametrize("case", CASES)
def test_l2_aux_loss_matches_jax(case):
    pred, target, pv, _ = _pair_case(case)
    t, pvt = torch.from_numpy(target), torch.from_numpy(pv)
    tp = t[torch.from_numpy(pv)]
    n_pos, n_neg = int((tp == 1).sum()), int((tp == 0).sum())
    capped = n_neg / (n_pos + 1) > 3
    assert capped == (case in ("cap_active", "cap_ties", "padded", "no_pos_row")), (n_pos, n_neg)
    _check_value_and_grad(
        lambda p: jax_track.l2_aux_loss(p, jnp.asarray(target), jnp.asarray(pv)),
        lambda p: track.l2_aux_loss(p, t, pvt), pred)


def test_l2_aux_loss_ties_keep_the_first_in_order():
    """With every negative cost equal, the cap keeps the first ``cap``
    negatives in row-major order, as JAX's stable argsort does."""
    target = np.zeros((4, 4), np.int32)
    target[0, 0] = 1
    pred = np.full((4, 4), 0.5, np.float32)
    pv = np.ones((4, 4), bool)
    x = torch.from_numpy(pred).requires_grad_(True)
    track.l2_aux_loss(x, torch.from_numpy(target), torch.from_numpy(pv)).backward()
    kept = np.flatnonzero(x.grad.numpy().ravel())
    np.testing.assert_array_equal(kept, [0, 1, 2, 3])  # the positive, then 3 negatives


def _track_inputs(seed=0, b=2, m=8, e=16):
    rng = np.random.RandomState(seed)
    key = rng.randn(b, m, e).astype(np.float32)
    ref = rng.randn(b, m, e).astype(np.float32)
    kval = np.zeros((b, m), bool)
    rval = np.zeros((b, m), bool)
    kval[0, :6], kval[1, :3] = True, True
    rval[0, :5], rval[1, :7] = True, True
    kids = np.where(kval, rng.randint(0, 6, (b, m)), -1).astype(np.int32)
    rids = np.where(rval, rng.randint(0, 6, (b, m)), -1).astype(np.int32)
    key *= kval[..., None]
    ref *= rval[..., None]
    return key, ref, kids, kval, rids, rval


def test_track_pair_losses_match_jax():
    key, ref, kids, kval, rids, rval = _track_inputs()
    jcfg = get_preset("debug_tiny_video").model
    jk = types.SimpleNamespace(thing_inst_ids=jnp.asarray(kids), thing_valid=jnp.asarray(kval))
    jr = types.SimpleNamespace(thing_inst_ids=jnp.asarray(rids), thing_valid=jnp.asarray(rval))

    def jax_total(ke, re):
        out = jax_video.track_pair_losses(jcfg, ke, re, jk, jr)
        return out["loss_track"] + out["loss_track_aux"], out

    (_, jout), (gk, gr) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(key), jnp.asarray(ref))
    pk = types.SimpleNamespace(thing_inst_ids=torch.from_numpy(kids),
                               thing_valid=torch.from_numpy(kval))
    pr = types.SimpleNamespace(thing_inst_ids=torch.from_numpy(rids),
                               thing_valid=torch.from_numpy(rval))
    ke = torch.from_numpy(key).requires_grad_(True)
    re = torch.from_numpy(ref).requires_grad_(True)
    out = video_losses.track_pair_losses(model_preset("debug_tiny_video"), ke, re, pk, pr)
    (out["loss_track"] + out["loss_track_aux"]).backward()
    for name in ("loss_track", "loss_track_aux"):
        got = float(out[name].detach())
        assert got > 0
        np.testing.assert_allclose(got, float(jout[name]), rtol=1e-5, err_msg=name)
    for got, want in ((ke.grad, gk), (re.grad, gr)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("case", range(5))
def test_marginals_bit_equal_jax(case, factor):
    masks = _mask_cases()[case]
    h, w = masks.shape[1:]
    out_hw = (h * factor, w * factor)
    jrow, jcol = jax_roi.upsampled_support_marginals(jnp.asarray(masks), out_hw)
    prow, pcol = roi_align.upsampled_support_marginals(torch.from_numpy(masks), out_hw)
    np.testing.assert_array_equal(prow.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(pcol.numpy(), np.asarray(jcol))
    # the materialised form: the counts of the binarised upsample itself
    full = (np.asarray(jax_resize(jnp.asarray(masks), out_hw)) > 0).astype(np.float32)
    np.testing.assert_array_equal(prow.numpy(), full.sum(axis=2))
    np.testing.assert_array_equal(pcol.numpy(), full.sum(axis=1))
    boxes = roi_align.masks_to_boxes_mad(torch.from_numpy(full))
    assert torch.equal(boxes, roi_align.boxes_mad_from_marginals(prow, pcol))
    np.testing.assert_allclose(boxes.numpy(),
                               np.asarray(jax_roi.masks_to_boxes_mad(jnp.asarray(full))),
                               rtol=1e-5, atol=1e-4)


def _gt(masks):
    """A GT sample of (B, M, h, w) masks; the other fields are unused."""
    b, m = masks.shape[:2]
    z = torch.zeros((b, m))
    return GTSample(thing_masks=masks, thing_labels=z, thing_valid=z > 0, thing_inst_ids=z,
                    stuff_masks=z, stuff_valid=z > 0, depth=z, valid_mask=z)


@pytest.mark.parametrize("factor", [2, 4])
def test_gt_track_boxes_match(factor):
    """On the mask cases as one batch of 4 images of 5 slots: bit-equal to
    the port's masks_to_boxes_mad of gt_track_masks over the same (B * M)
    masks, and JAX's gt_track_boxes within its own box tolerance."""
    masks = np.concatenate(_mask_cases())[:20].reshape(4, 5, 32, 48)
    pad_hw = (32 * factor, 48 * factor)
    got = video_losses.gt_track_boxes(_gt(torch.from_numpy(masks)), pad_hw)
    want = jax_video.gt_track_boxes(types.SimpleNamespace(thing_masks=jnp.asarray(masks)),
                                    pad_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    full = video_losses.gt_track_masks(_gt(torch.from_numpy(masks)), pad_hw)
    assert full.shape == (4, 5) + pad_hw and full.dtype == torch.float32
    oracle = roi_align.masks_to_boxes_mad(full.flatten(0, 1)).reshape(4, 5, 4)
    assert torch.equal(got, oracle)
    assert (got[..., 2:] > got[..., :2]).any()


def _rois(rng, m, h, w):
    """Boxes of every FPN level's size at an (h, w) image, two past the
    border and one empty."""
    size = rng.uniform(4, min(h, w) * 1.2, m)
    cx, cy = rng.uniform(0, w, m), rng.uniform(0, h, m)
    boxes = np.stack([cx - size / 2, cy - size / 2, cx + size / 2, cy + size / 2], 1)
    boxes = np.maximum(boxes, 0.0)
    boxes[0] = [w - 10, h - 6, w + 30, h + 12]
    boxes[1] = 0.0
    return boxes.astype(np.float32)


def test_separable_roi_align_matches_jax():
    rng = np.random.RandomState(5)
    h, w, c = 256, 512, 8
    feats = [rng.randn(h // s, w // s, c).astype(np.float32) for s in (4, 8, 16, 32)]
    rois = _rois(rng, 24, h, w)
    lv = jax_roi.map_roi_levels(jnp.asarray(rois))
    assert len(set(np.asarray(lv).tolist())) >= 3  # several levels routed
    want = np.asarray(jax_roi.multilevel_roi_align_separable(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    tf = [torch.from_numpy(f) for f in feats]
    got = roi_align.multilevel_roi_align_separable(tf, torch.from_numpy(rois)).numpy()
    assert got.shape == want.shape == (24, 7, 7, c)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    gather = roi_align.multilevel_roi_align(tf, torch.from_numpy(rois)).numpy()
    assert np.abs(got - gather).max() <= 1e-4 * np.abs(gather).max()


def test_track_head_masks_form_equals_boxes_form():
    """forward_track_embeds from masks equals it from their MAD boxes, in
    both RoIAlign forms; the separable form within 1e-4 of the gather."""
    import dataclasses

    rng = np.random.RandomState(2)
    cfg = model_preset("debug_tiny_video")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    feats = [torch.from_numpy(rng.randn(2, 64, 64 // s, 128 // s).astype(np.float32))
             for s in (4, 8, 16, 32)]
    masks = torch.from_numpy((rng.rand(2, 5, 16, 32) > 0.7).astype(np.float32))
    full = video_losses.gt_track_masks(_gt(masks), (64, 128))
    valid = torch.tensor([[True, True, True, False, True], [True, False, True, True, False]])
    boxes = torch.stack([roi_align.masks_to_boxes_mad(full[b]) for b in range(2)])
    out = {}
    with torch.no_grad():
        for impl in ("gather", "separable"):
            model.track_head.cfg = dataclasses.replace(cfg.track_head, roi_impl=impl)
            a = model.forward_track_embeds(feats, full, valid)
            b = model.forward_track_embeds(feats, None, valid, boxes=boxes)
            assert torch.equal(a, b), impl
            out[impl] = a
    assert (out["gather"][~valid] == 0).all()
    diff = (out["separable"] - out["gather"]).abs().max()
    assert diff <= 1e-4 * out["gather"].abs().max()


def test_roi_gather_gradient_equals_indexing(monkeypatch):
    """The RoIAlign row gather is an embedding lookup; its gradient equals
    that of ``table[index]`` (within 1e-6 of the largest, sums of repeated
    rows in another order), padded zero boxes included: every sample of
    one reads the same corner."""
    rng = np.random.RandomState(6)
    feats = [torch.from_numpy(rng.randn(64 // s, 128 // s, 8).astype(np.float32))
             for s in (4, 8, 16, 32)]
    rois = torch.from_numpy(_rois(rng, 12, 64, 128))
    rois[6:] = 0.0
    cot = torch.from_numpy(rng.randn(12, 7, 7, 8).astype(np.float32))
    grads = []
    for rows in (roi_align._rows, lambda table, index: table[index]):
        monkeypatch.setattr(roi_align, "_rows", rows)
        fs = [f.clone().requires_grad_(True) for f in feats]
        roi_align.multilevel_roi_align(fs, rois).backward(cot)
        grads.append([f.grad for f in fs])
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert grads[0][0][0, 0].abs().sum() > 0
