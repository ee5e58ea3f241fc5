"""Gradients of the port's 2-frame video loss against ``jax.value_and_grad``
of the JAX package's ``video_forward_losses``, on the CPU, and the video
train step's guards.

``debug_tiny_video`` at 64x128, batch 1 of ``synthetic_batch(two_frame=True,
seed=0)``; one set of weights, drawn for the port from a seeded
``torch.Generator`` and bridged to JAX, and the port's gradients mapped
through the same bridge.  The JAX gradient is compiled once, in the module
fixture.

Tolerances, those of ``tests/test_torch_train_grads.py``: the total loss
within rtol 1e-4; every trainable gradient leaf (the track head and the
backbone included) within atol 1e-6 + rtol 1e-3 of the leaf's largest
magnitude; the frozen leaves take no gradient in the port.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.data.loader import synthetic_batch as jax_synthetic_batch
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.train.optim import is_frozen as jax_is_frozen
from polyphonicformer_tpu.train.video_losses import video_forward_losses as jax_video_losses
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.train.step import create_train_state, make_train_step
from polyphonicformer_torch.train.video_losses import video_forward_losses
from polyphonicformer_torch.weights import flatten_tree, to_jax_variables, to_numpy_state_dict

H, W = 64, 128


def _port(pexp):
    return build_model(pexp.model, "cpu", generator=torch.Generator().manual_seed(0))


def _batch(pexp, **kw):
    return synthetic_batch(pexp.model, 1, (H, W), two_frame=True, seed=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def grads():
    jcfg = get_preset("debug_tiny_video").model
    pexp = preset("debug_tiny_video")
    port = _port(pexp)
    variables = to_jax_variables(to_numpy_state_dict(port), pexp.model)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    consts = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    jbatch = jax.tree_util.tree_map(
        jnp.asarray, jax_synthetic_batch(jcfg, 1, hw=(H, W), two_frame=True, seed=0))

    def loss_fn(p):
        return jax_video_losses(JaxModel(jcfg), {"params": p, **consts}, jcfg, jbatch)[0]

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    state, _ = create_train_state(port, pexp, None, device="cpu")
    model = state.model
    feats = []
    extract = model.extract_feat

    def recording(img):  # the key frame's features, then the ref frame's
        out = extract(img)
        feats.append(out)
        return out

    model.extract_feat = recording
    total, parts = video_forward_losses(model, pexp.model, _batch(pexp))
    del model.extract_feat
    total.backward()
    pgrads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
              if p.grad is not None}
    return dict(jax_total=float(jtotal), port_total=float(total.detach()), feats=feats,
                port_parts={k: float(v.detach()) for k, v in parts.items()},
                jax=flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads)),
                port=flatten_tree(to_jax_variables(pgrads, pexp.model, partial=True)["params"]))


def test_video_total_loss_matches_jax(grads):
    np.testing.assert_allclose(grads["port_total"], grads["jax_total"], rtol=1e-4)
    assert grads["port_parts"]["loss_track"] > 0 and grads["port_parts"]["loss_track_aux"] > 0


def test_every_video_gradient_matches_jax(grads):
    jg, pg = grads["jax"], grads["port"]
    frozen = {k for k in jg if jax_is_frozen(k)}
    assert set(pg) == set(jg) - frozen and len(frozen) == 33
    assert any(k.startswith("track_head/") for k in pg)
    assert any(k.startswith("backbone/") for k in pg)
    for k, g in pg.items():
        want = jg[k]
        assert np.isfinite(g).all(), k
        assert np.abs(g - want).max() <= 1e-6 + 1e-3 * np.abs(want).max(), k


def test_ref_features_carry_no_graph(grads):
    key, ref = grads["feats"]
    assert all(f.requires_grad and f.grad_fn is not None for f in key)
    assert not any(f.requires_grad or f.grad_fn is not None for f in ref)


def _video_step_once(pexp, **batch_replace):
    state, opt = create_train_state(_port(pexp), pexp, None, device="cpu")
    step = make_train_step(state.model, pexp, opt, video=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = step(state, _batch(pexp)._replace(**batch_replace))
    return state, metrics, before


def test_uint8_video_batch_is_normalized_with_the_config():
    """uint8 key and ref images give the loss of the same images normalised
    on the host with ``DataConfig.mean`` / ``std``."""
    pexp = preset("debug_tiny_video")
    pexp = dataclasses.replace(pexp, data=dataclasses.replace(
        pexp.data, mean=(100.0, 110.0, 120.0), std=(50.0, 55.0, 60.0)))
    rng = np.random.RandomState(7)
    u8 = [rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8) for _ in range(2)]
    host = [((u.astype(np.float32) - np.float32(pexp.data.mean))
             / np.float32(pexp.data.std)).astype(np.float32) for u in u8]
    _, m_u8, _ = _video_step_once(pexp, image=torch.from_numpy(u8[0]),
                                  ref_image=torch.from_numpy(u8[1]))
    _, m_f32, _ = _video_step_once(pexp, image=torch.from_numpy(host[0]),
                                   ref_image=torch.from_numpy(host[1]))
    for k in ("total_loss", "loss_track", "loss_track_aux"):
        np.testing.assert_allclose(float(m_u8[k]), float(m_f32[k]), rtol=1e-6, err_msg=k)


def test_bf16_video_step_keeps_f32_master_weights():
    pexp = preset("debug_tiny_video")
    half = dataclasses.replace(pexp, model=dataclasses.replace(pexp.model,
                                                               compute_dtype="bfloat16"))
    state, metrics, before = _video_step_once(half)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["loss_track"]) > 0
    w = state.model.track_head.fc_embed.weight
    assert w.dtype == torch.float32
    assert not torch.equal(w, before["track_head.fc_embed.weight"])
    assert torch.equal(state.model.backbone.conv1.weight, before["backbone.conv1.weight"])


def test_video_step_refuses_without_track_head_or_ref_frame():
    pexp = preset("debug_tiny")
    state, opt = create_train_state(_port(pexp), pexp, None, device="cpu")
    with pytest.raises(ValueError, match="with_track"):
        make_train_step(state.model, pexp, opt, video=True)
    vexp = preset("debug_tiny_video")
    state, opt = create_train_state(_port(vexp), vexp, None, device="cpu")
    step = make_train_step(state.model, vexp, opt, video=True)
    with pytest.raises(ValueError, match="ref_image"):
        step(state, synthetic_batch(vexp.model, 1, (H, W), seed=0, device="cpu"))
