"""The port's 2-frame video train step against the JAX package's
``make_train_step(video=True)`` on the CPU, over a 3-step trajectory.

``debug_tiny_video`` (``debug_tiny`` with the track head), 64x128 images,
batch 2 of ``synthetic_batch(two_frame=True, seed=0)``, lr 5e-4 without
warmup.  One set of weights, drawn for the port from a seeded
``torch.Generator`` and bridged to JAX.  The JAX step is compiled once, in
the module fixture.

Tolerances, those of ``tests/test_torch_train_step.py``: the first step's
loss dict (``loss_track`` and ``loss_track_aux`` included) within rtol
1e-4, the later totals within rtol 1e-3, the key frame's assignments of
each step equal; the parameters after 3 steps within rtol 1e-3, atol 1e-6
in L2 over the whole vector, each leaf's 3-step change within 10% in L2
and the median leaf within 1%.  The track head's ``fc_embed`` moves.
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
from polyphonicformer_tpu.train.optim import make_optimizer
from polyphonicformer_tpu.train.step import TrainState as JaxTrainState
from polyphonicformer_tpu.train.step import make_train_step as jax_make_train_step
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.train import losses
from polyphonicformer_torch.train.step import create_train_state, make_train_step
from polyphonicformer_torch.weights import flatten_tree, to_jax_variables, to_numpy_state_dict
from tests.test_torch_train_step import _jax_assign

H, W, B, STEPS = 64, 128, 2, 3
SCHEDULE = dict(lr=5e-4, warmup_iters=1, warmup_ratio=1.0)
FC_EMBED = "track_head/embed_mlp/fc_embed/kernel"


@pytest.fixture(scope="module")
def runs():
    jexp = get_preset("debug_tiny_video")
    jexp = dataclasses.replace(jexp, schedule=dataclasses.replace(jexp.schedule, **SCHEDULE))
    pexp = preset("debug_tiny_video")
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
    jstep = jax_make_train_step(model, jcfg, tx, video=True, donate=False)
    jbatch = jax.tree_util.tree_map(
        jnp.asarray, jax_synthetic_batch(jcfg, B, hw=(H, W), two_frame=True, seed=0))
    jassign = jax.jit(lambda p, img, gt: _jax_assign(
        jcfg, model.apply({"params": p, **consts}, img), gt))

    state, opt = create_train_state(port, pexp, None, steps_per_epoch=1000, device="cpu")
    step = make_train_step(state.model, pexp, opt, video=True)
    batch = synthetic_batch(pexp.model, B, (H, W), two_frame=True, seed=0, device="cpu")
    np.testing.assert_array_equal(batch.ref_image.numpy(), np.asarray(jbatch.ref_image))

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
def test_video_step_losses_and_assignments_match_jax(runs, i):
    jm, pm = runs["jax_metrics"][i], runs["port_metrics"][i]
    assert {"loss_track", "loss_track_aux"} <= set(pm)
    # grad_norm: JAX also counts the frozen gradients (test_torch_train_grads.py)
    keys = [k for k in jm if k != "grad_norm"] if i == 0 else ["total_loss"]
    for k in keys:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4 if i == 0 else 1e-3, atol=1e-6,
                                   err_msg=f"{k} step {i}")
    np.testing.assert_array_equal(runs["port_assign"][i], runs["jax_assign"][i])
    assert pm["loss_track"] > 0 and pm["loss_track_aux"] > 0
    assert pm["skipped_nonfinite"] == 0.0


def test_video_loss_falls_and_steps_count(runs):
    totals = [m["total_loss"] for m in runs["port_metrics"]]
    assert totals[-1] < totals[0], totals
    assert runs["port_step"] == STEPS


def test_video_params_after_three_steps_match_jax(runs):
    jp, pp, p0 = runs["jax_params"], runs["port_params"], runs["init_params"]
    assert set(jp) == set(pp) and FC_EMBED in jp
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
    # the track head trained on both sides
    assert np.abs(pp[FC_EMBED] - p0[FC_EMBED]).max() > 0 and FC_EMBED in rel
    assert sum(k.startswith("track_head/") for k in rel) >= 10
