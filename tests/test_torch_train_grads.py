"""Gradients of the port's image-model loss against ``jax.value_and_grad``
of the JAX package's, on the CPU, and the train step's guards.

``debug_tiny`` at 64x128, batch 1 of ``synthetic_batch(seed=0)``; one set
of weights, drawn for the port from a seeded ``torch.Generator`` and
bridged to JAX (``weights.to_jax_variables``), and the port's gradients
mapped through the same bridge.  The JAX gradient is compiled once, in the
module fixture.

Tolerances: the total loss within rtol 1e-4; every trainable gradient leaf
within atol 1e-6 + rtol 1e-3 of the leaf's largest magnitude (entries near
zero of a dense gradient carry the f32 noise of the whole sum, ~1e-6 of
the leaf's scale, so an entry-relative bound does not apply); the frozen
leaves take no gradient in the port.
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
from polyphonicformer_tpu.train.losses import compute_losses as jax_compute_losses
from polyphonicformer_tpu.train.optim import is_frozen as jax_is_frozen
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.train.losses import compute_losses
from polyphonicformer_torch.train.step import create_train_state, make_train_step
from polyphonicformer_torch.weights import flatten_tree, to_jax_variables, to_numpy_state_dict

H, W = 64, 128


def _port(pexp):
    return build_model(pexp.model, "cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def grads():
    jcfg = get_preset("debug_tiny").model
    pexp = preset("debug_tiny")
    port = _port(pexp)
    variables = to_jax_variables(to_numpy_state_dict(port), pexp.model)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    consts = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(jcfg, 1, hw=(H, W), seed=0))

    def loss_fn(p):
        out = JaxModel(jcfg).apply({"params": p, **consts}, jbatch.image)
        return jax_compute_losses(jcfg, out, jbatch.gt)[0]

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

    state, opt = create_train_state(port, pexp, None, device="cpu")
    batch = synthetic_batch(pexp.model, 1, (H, W), seed=0, device="cpu")
    total, _ = compute_losses(pexp.model, state.model(batch.image), batch.gt)
    total.backward()
    pgrads = {k: p.grad.numpy().copy() for k, p in state.model.named_parameters()
              if p.grad is not None}
    return dict(jax_total=float(jtotal), port_total=float(total.detach()),
                jax=flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads)),
                port=flatten_tree(to_jax_variables(pgrads, pexp.model, partial=True)["params"]),
                port_norm=float(opt.clip_grads()))


def test_total_loss_matches_jax(grads):
    np.testing.assert_allclose(grads["port_total"], grads["jax_total"], rtol=1e-4)


def test_every_gradient_matches_jax(grads):
    jg, pg = grads["jax"], grads["port"]
    frozen = {k for k in jg if jax_is_frozen(k)}
    assert set(pg) == set(jg) - frozen and len(frozen) == 33
    for k, g in pg.items():
        want = jg[k]
        assert np.isfinite(g).all(), k
        assert np.abs(g - want).max() <= 1e-6 + 1e-3 * np.abs(want).max(), k


def test_grad_norm_is_the_trainable_norm(grads):
    """The port's grad_norm (the norm the clip sees) against the JAX
    gradients' global norm over the trainable leaves, rtol 1e-4."""
    jg = grads["jax"]
    want = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for k, g in jg.items() if not jax_is_frozen(k)))
    np.testing.assert_allclose(grads["port_norm"], want, rtol=1e-4)


def _step_once(pexp, image, **batch_kw):
    port = _port(pexp)
    state, opt = create_train_state(port, pexp, None, device="cpu")
    step = make_train_step(state.model, pexp, opt)
    batch = synthetic_batch(pexp.model, 1, (H, W), seed=0, device="cpu")._replace(image=image)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    adam = [t.clone() for t in opt.state()]
    state, metrics = step(state, batch)
    return state, opt, metrics, before, adam


def test_nan_guard_keeps_params_and_optimizer_state():
    pexp = preset("debug_tiny")
    image = synthetic_batch(pexp.model, 1, (H, W), seed=0, device="cpu").image.clone()
    image[0, 0, 0, 0] = float("nan")
    state, opt, metrics, before, adam = _step_once(pexp, image)
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(metrics["total_loss"]))
    assert int(state.step) == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(opt.state(), adam):
        assert torch.equal(a, b)


def test_uint8_image_is_normalized_with_the_config():
    """A uint8 batch gives the loss of the same image normalised on the
    host with ``DataConfig.mean`` / ``std`` (fault F3 of the JAX package:
    its step hard-codes them)."""
    pexp = preset("debug_tiny")
    pexp = dataclasses.replace(pexp, data=dataclasses.replace(
        pexp.data, mean=(100.0, 110.0, 120.0), std=(50.0, 55.0, 60.0)))
    u8 = np.random.RandomState(7).randint(0, 256, (1, H, W, 3)).astype(np.uint8)
    host = ((u8.astype(np.float32) - np.float32(pexp.data.mean))
            / np.float32(pexp.data.std)).astype(np.float32)
    _, _, m_u8, _, _ = _step_once(pexp, torch.from_numpy(u8))
    _, _, m_f32, _, _ = _step_once(pexp, torch.from_numpy(host))
    np.testing.assert_allclose(float(m_u8["total_loss"]), float(m_f32["total_loss"]), rtol=1e-6)


def test_bf16_compute_keeps_f32_master_weights():
    """compute_dtype='bfloat16': the forward runs in bf16 from f32 master
    weights; the loss is finite and within 5% of the f32 loss, the master
    weights stay f32 and the trainable ones move."""
    pexp = preset("debug_tiny")
    image = synthetic_batch(pexp.model, 1, (H, W), seed=0, device="cpu").image
    _, _, m32, _, _ = _step_once(pexp, image)
    half = dataclasses.replace(pexp, model=dataclasses.replace(pexp.model,
                                                               compute_dtype="bfloat16"))
    state, _, m16, before, _ = _step_once(half, image)
    assert float(m16["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(float(m16["total_loss"]), float(m32["total_loss"]), rtol=5e-2)
    w = state.model.backbone.layer2[0].conv1.weight
    assert w.dtype == torch.float32
    assert not torch.equal(w, before["backbone.layer2.0.conv1.weight"])
    assert torch.equal(state.model.backbone.conv1.weight, before["backbone.conv1.weight"])


def test_create_train_state_draws_weights_from_the_generator():
    """With a generator, create_train_state initialises a meta-device model
    with exactly the weights build_model draws from the same seed."""
    from polyphonicformer_torch.models.polyphonic import PolyphonicFormer

    pexp = preset("debug_tiny")
    with torch.device("meta"):
        model = PolyphonicFormer(pexp.model)
    state, opt = create_train_state(model, pexp, torch.Generator().manual_seed(0), device="cpu")
    want = _port(pexp).state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert state.model.training and not state.model.backbone.conv1.weight.requires_grad
    assert len(opt.params) == sum(p.requires_grad for p in state.model.parameters())
