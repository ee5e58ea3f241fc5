"""The port's modules against the JAX package's, in f32, on one set of
weights: drawn for the port from a seeded ``torch.Generator`` and bridged to
JAX variables with ``convert_state_dict``.  Widths of ``debug_tiny_video``
(64 channels, ff 128, 20 proposals), image 64x128.

Layouts: JAX features are NHWC and the port's NCHW, so every JAX feature map
below is transposed (0, 3, 1, 2) before the comparison; mask logits, query
tensors and embeddings share one layout.  Tolerance: max |port - jax| <=
1e-4 * max |jax| per output (f32 sums in another order)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools.convert_torch_ckpt import convert_state_dict
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.weights import to_numpy_state_dict

H, W = 64, 128


def _close(name, jax_out, port_out, transpose=False):
    want = np.asarray(jax_out, np.float32)
    if transpose:
        want = want.transpose(0, 3, 1, 2)
    got = port_out.detach().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    cfg = get_preset("debug_tiny_video").model
    port = build_model(model_preset("debug_tiny_video"), "cpu",
                       generator=torch.Generator().manual_seed(0))
    variables = convert_state_dict(to_numpy_state_dict(port), cfg)
    jm = JaxModel(cfg)
    img = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    fpn_j = jm.apply(variables, jnp.asarray(img), method=JaxModel.extract_feat)
    with torch.no_grad():
        fpn_p = port.extract_feat(torch.from_numpy(img))
    return cfg, port, jm, variables, fpn_j, fpn_p


def test_resnet_fpn(setup):
    _, _, _, _, fpn_j, fpn_p = setup
    for i, (a, b) in enumerate(zip(fpn_j, fpn_p)):
        _close(f"P{i + 2}", a, b, transpose=True)


def test_kernel_head(setup):
    """Port and JAX heads both take the JAX P2..P5 (transposed for the
    port), so only the head's own arithmetic is compared."""
    _, port, jm, variables, fpn_j, _ = setup
    rpn_j = jm.apply(variables, fpn_j, method=lambda m, f: m.rpn_head(f))
    with torch.no_grad():
        rpn_p = port.rpn_head([torch.from_numpy(np.array(f)).permute(0, 3, 1, 2)
                               for f in fpn_j])
    _close("mask_preds", rpn_j.mask_preds, rpn_p.mask_preds)
    _close("proposal_feats", rpn_j.proposal_feats, rpn_p.proposal_feats)
    _close("x_feats", rpn_j.x_feats, rpn_p.x_feats, transpose=True)
    _close("depth_feats", rpn_j.depth_feats, rpn_p.depth_feats, transpose=True)
    _close("seg_preds", rpn_j.seg_preds, rpn_p.seg_preds, transpose=True)
    _close("depth_pred", rpn_j.depth_pred, rpn_p.depth_pred)
    _close("depth_proposal", rpn_j.depth_proposal, rpn_p.depth_proposal)


def test_kernel_update_head(setup):
    """Stage 0 on the JAX rpn outputs (feature maps transposed to NCHW)."""
    _, port, jm, variables, fpn_j, _ = setup
    rpn = jm.apply(variables, fpn_j, method=lambda m, f: m.rpn_head(f))
    args = (rpn.x_feats, rpn.proposal_feats, rpn.mask_preds, rpn.depth_proposal,
            rpn.depth_feats)
    out_j = jm.apply(variables, *args, method=lambda m, *a: m.mask_heads[0](*a))
    t = [torch.from_numpy(np.array(a)) for a in args]
    with torch.no_grad():
        out_p = port.roi_head.mask_head[0](t[0].permute(0, 3, 1, 2), t[1], t[2], t[3],
                                           t[4].permute(0, 3, 1, 2))
    for name in ("cls_score", "mask_preds", "obj_feats", "depth_preds", "depth_kernels"):
        _close(name, getattr(out_j, name), getattr(out_p, name))


def test_forward_heads(setup):
    """All three stages from the image, each side on its own features."""
    _, port, jm, variables, fpn_j, fpn_p = setup
    out_j = jm.apply(variables, fpn_j, method=JaxModel.forward_heads)
    with torch.no_grad():
        out_p = port.forward_heads(fpn_p)
    for s, (a, b) in enumerate(zip(out_j.stages, out_p.stages)):
        for name in ("cls_score", "mask_preds", "depth_preds", "obj_feats"):
            _close(f"stage{s}.{name}", getattr(a, name), getattr(b, name))


def test_track_head(setup):
    """RoIAlign embeddings for 6 boxes (2 invalid) on the JAX P2..P5.  The
    JAX tower flattens (7, 7, C), the port's (C, 7, 7); the bridge's
    linear_chw2hwc_7 entry makes the two agree."""
    cfg, port, jm, variables, fpn_j, _ = setup
    rng = np.random.RandomState(1)
    xy = rng.rand(1, 6, 2) * [W * 0.6, H * 0.6]
    boxes = np.concatenate([xy, xy + rng.rand(1, 6, 2) * [W * 0.4, H * 0.4] + 1],
                           axis=2).astype(np.float32)
    valid = np.array([[True, True, False, True, True, False]])
    dummy = jnp.zeros((1, 6, 1, 1), jnp.bool_)
    emb_j = jm.apply(variables, fpn_j, dummy, jnp.asarray(valid), jnp.asarray(boxes),
                     method=JaxModel.forward_track_embeds)
    with torch.no_grad():
        emb_p = port.forward_track_embeds(
            [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in fpn_j],
            None, torch.from_numpy(valid), boxes=torch.from_numpy(boxes))
    assert emb_p.shape == (1, 6, cfg.track_head.embed_channels)
    _close("embeds", emb_j, emb_p)


def test_mask_pool_thresholds_tiny_logits_like_jax():
    """The hard mask keeps sigmoid(x) > 0.5 in f32: tiny positive logits
    round to exactly 0.5 and are out, as in the JAX package."""
    from polyphonicformer_torch.ops.cuda.mask_pool import masked_pool

    logits = torch.tensor([[[[1e-9, 1e-6, 0.0, -1e-9]]]])
    feats = torch.ones((1, 1, 4, 1))
    assert masked_pool(logits, feats).item() == 1.0  # only 1e-6 passes


@pytest.mark.parametrize("seed", [0, 1])
def test_fpn_top_down_matches(seed):
    """The FPN alone on random C2..C5 (a second check of the top-down
    nearest path and the bridged lateral/output convs)."""
    cfg = get_preset("debug_tiny_video").model
    port = build_model(model_preset("debug_tiny_video"), "cpu",
                       generator=torch.Generator().manual_seed(seed))
    variables = convert_state_dict(to_numpy_state_dict(port), cfg)
    rng = np.random.RandomState(seed)
    feats = [rng.randn(1, 16 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((256, 512, 1024, 2048))]
    jm = JaxModel(cfg)
    out_j = jm.apply(variables, [jnp.asarray(f) for f in feats],
                     method=lambda m, f: m.neck(f))
    with torch.no_grad():
        out_p = port.neck([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for i, (a, b) in enumerate(zip(out_j, out_p)):
        _close(f"P{i + 2}", a, b, transpose=True)
