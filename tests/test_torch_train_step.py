"""The port's image-model train step against the JAX package's
``make_train_step`` on the CPU, over a 3-step trajectory.

``debug_tiny`` (20 proposals + 11 stuff rows, 3 stages, ResNet-50 + FPN at
64 channels), 64x128 images, batch 2 of ``synthetic_batch(seed=0)``, lr
5e-4 without warmup, backbone lr_mult 0.25, clip 1.0.  One set of weights,
drawn for the port from a seeded ``torch.Generator`` and bridged to JAX.
The JAX step is compiled once, in the module fixture.

Tolerances.  The first step's loss dict within rtol 1e-4 (identical
weights), the total loss of the later steps within rtol 1e-3; the
assignments of each step equal.  Parameters after 3 steps: the whole
parameter vector within rtol 1e-3, atol 1e-6 in L2, each leaf's 3-step
change within 10% in L2 and the median leaf within 1%.  The gradients of the two frameworks agree to
~1e-5 relative per leaf (``test_torch_train_grads.py``), but Adam divides
each gradient element by its own magnitude: an element whose gradient is
near f32 noise gets an update of arbitrary sign on either side, so an
element-wise bound on the parameters cannot hold for any two f32
implementations.
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
from polyphonicformer_tpu.train import assign as jax_assign
from polyphonicformer_tpu.train import losses as jax_losses
from polyphonicformer_tpu.train.optim import make_optimizer
from polyphonicformer_tpu.train.step import TrainState as JaxTrainState
from polyphonicformer_tpu.train.step import make_train_step as jax_make_train_step
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.train import losses
from polyphonicformer_torch.train.step import create_train_state, make_train_step
from polyphonicformer_torch.weights import flatten_tree, to_jax_variables, to_numpy_state_dict

H, W, B, STEPS = 64, 128, 2, 3
SCHEDULE = dict(lr=5e-4, warmup_iters=1, warmup_ratio=1.0)


def _jax_assign(cfg, out, gt):
    """The JAX package's shared-branch matching (train/losses.py:281-311)."""
    s, np_, nt = cfg.num_stages, cfg.num_proposals, cfg.num_thing_classes
    acfg = cfg.rcnn_assigner
    up = jax_losses._upsample2(jnp.stack([out.rpn.mask_preds]
                                         + [so.mask_preds for so in out.stages]))
    cls = jnp.stack([so.cls_score for so in out.stages])
    costs = jax_assign.mask_dice_costs_stacked(acfg, up[:s, :, :np_], gt)
    cls_c = jax.vmap(jax.vmap(lambda c, l: jax_assign.focal_cls_cost(
        c, l, acfg.focal_gamma, acfg.focal_alpha)), in_axes=(0, None))(
        cls[:s - 1, :, :np_, :nt], gt.thing_labels)
    costs = costs.at[1:].add(acfg.cls_weight * cls_c)
    b = gt.thing_valid.shape[0]
    res = jax_assign.solve_assignments_lockstep(costs.reshape((s * b,) + costs.shape[2:]),
                                                jnp.tile(gt.thing_valid, (s, 1)))
    return res.gt2pred.reshape(s, b, -1)


@pytest.fixture(scope="module")
def runs():
    jexp = get_preset("debug_tiny")
    jexp = dataclasses.replace(jexp, schedule=dataclasses.replace(jexp.schedule, **SCHEDULE))
    pexp = preset("debug_tiny")
    pexp = dataclasses.replace(pexp, schedule=dataclasses.replace(pexp.schedule, **SCHEDULE))
    jcfg = jexp.model

    port = build_model(pexp.model, "cpu", generator=torch.Generator().manual_seed(0))
    variables = to_jax_variables(to_numpy_state_dict(port), pexp.model)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    consts = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    model = JaxModel(jcfg)
    tx = make_optimizer(jexp.schedule, params, 1000, jcfg.frozen_stages)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, consts=consts,
                           opt_state=tx.init(params))
    jstep = jax_make_train_step(model, jcfg, tx, donate=False)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(jcfg, B, hw=(H, W), seed=0))
    jassign = jax.jit(lambda p, img, gt: _jax_assign(
        jcfg, model.apply({"params": p, **consts}, img), gt))

    state, opt = create_train_state(port, pexp, None, steps_per_epoch=1000, device="cpu")
    step = make_train_step(state.model, pexp, opt)
    batch = synthetic_batch(pexp.model, B, (H, W), seed=0, device="cpu")

    out = dict(jax_metrics=[], port_metrics=[], jax_assign=[], port_assign=[])
    for _ in range(STEPS):
        out["jax_assign"].append(np.asarray(jassign(jstate.params, jbatch.image, jbatch.gt)))
        with torch.no_grad():
            asg = losses.assign(pexp.model, state.model(batch.image), batch.gt)
        out["port_assign"].append(np.stack([a.gt2pred[:, 0].numpy() for a in asg.assigns[1:]]))
        jstate, jm = jstep(jstate, jbatch)
        state, pm = step(state, batch)
        out["jax_metrics"].append({k: float(v) for k, v in jm.items()})
        out["port_metrics"].append({k: float(v) for k, v in pm.items()})
    out["jax_params"] = flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    out["port_params"] = flatten_tree(
        to_jax_variables(to_numpy_state_dict(state.model), pexp.model)["params"])
    out["init_params"] = flatten_tree(variables["params"])
    out["port_step"] = int(state.step)
    return out


@pytest.mark.parametrize("i", range(STEPS))
def test_step_losses_and_assignments_match_jax(runs, i):
    jm, pm = runs["jax_metrics"][i], runs["port_metrics"][i]
    # grad_norm: JAX also counts the frozen gradients (test_torch_train_grads.py)
    keys = [k for k in jm if k != "grad_norm"] if i == 0 else ["total_loss"]
    for k in keys:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4 if i == 0 else 1e-3, atol=1e-6,
                                   err_msg=f"{k} step {i}")
    np.testing.assert_array_equal(runs["port_assign"][i], runs["jax_assign"][i])
    assert (runs["jax_assign"][i] >= 0).any()
    assert pm["skipped_nonfinite"] == 0.0


def test_loss_falls_and_steps_count(runs):
    totals = [m["total_loss"] for m in runs["port_metrics"]]
    assert totals[-1] < totals[0], totals
    assert runs["port_step"] == STEPS


def test_params_after_three_steps_match_jax(runs):
    jp, pp, p0 = runs["jax_params"], runs["port_params"], runs["init_params"]
    assert set(jp) == set(pp)
    a = np.concatenate([pp[k].ravel() for k in jp])
    b = np.concatenate([jp[k].ravel() for k in jp])
    assert np.linalg.norm(a - b) <= 1e-6 * np.sqrt(a.size) + 1e-3 * np.linalg.norm(b)
    rel = {}
    for k in jp:
        delta = jp[k] - p0[k]
        if not delta.any():  # frozen: unchanged on both sides
            np.testing.assert_array_equal(pp[k], p0[k], err_msg=k)
            continue
        rel[k] = np.linalg.norm(pp[k] - jp[k]) / np.linalg.norm(delta)
    worst = max(rel, key=rel.get)
    assert rel[worst] < 0.1, (worst, rel[worst])
    assert np.median(list(rel.values())) < 1e-2
    assert len(rel) > 300
