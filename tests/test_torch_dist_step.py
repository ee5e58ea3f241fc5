"""The port's data-parallel train step on 2 gloo ranks against the JAX
package's ``make_sharded_train_step`` on a 2-device mesh, on the CPU.

``debug_tiny`` (image) and ``debug_tiny_video`` (2-frame), 64x128,
global batch 2 of ``synthetic_batch(seed=0)``: each rank takes one sample
(``parallel.mesh.local_slice``), JAX the whole batch on
``make_mesh(ParallelConfig(), jax.devices()[:2])``.  The ranks draw their
weights from different seeds; rank 0's (seed 0, bridged to JAX) reach
both through the step's broadcast.  2 steps, lr 5e-4 without warmup.

Tolerances, those of ``tests/test_torch_train_step.py``: the first
step's loss dict within rtol 1e-4 (``grad_norm`` left out: JAX counts the
frozen gradients too), the second step's total within rtol 1e-3; the
parameters after the steps within rtol 1e-3, atol 1e-6 in L2 over the
whole vector, each leaf's change within 10% in L2.  The two ranks'
metrics and parameters are bit-identical.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import ParallelConfig as JaxParallelConfig
from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.data.loader import synthetic_batch as jax_synthetic_batch
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from polyphonicformer_tpu.train.optim import make_optimizer
from polyphonicformer_tpu.train.step import TrainState as JaxTrainState
from polyphonicformer_tpu.train.step import make_sharded_train_step as jax_sharded_step
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.weights import flatten_tree, to_jax_variables, to_numpy_state_dict
from tests.torch_dist_ranks import H, SCHEDULE, W, _experiment, start_ranks

B, STEPS, TIMEOUT = 2, 2, 280


@pytest.fixture(scope="module", params=[False, True], ids=["image", "video"])
def runs(request, tmp_path_factory):
    video = request.param
    torch.set_num_threads(2)
    ranks = start_ranks(tmp_path_factory.mktemp("dp"), "dp_step", 2, TIMEOUT, video=video,
                        steps=STEPS, batch=B)
    name = "debug_tiny_video" if video else "debug_tiny"
    jexp = get_preset(name)
    jexp = dataclasses.replace(jexp, schedule=dataclasses.replace(jexp.schedule, **SCHEDULE))
    pexp = _experiment(name)
    jcfg = jexp.model
    port = build_model(pexp.model, "cpu", generator=torch.Generator().manual_seed(0))
    variables = to_jax_variables(to_numpy_state_dict(port), pexp.model)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    consts = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    tx = make_optimizer(jexp.schedule, params, 1000, jcfg.frozen_stages)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, consts=consts,
                           opt_state=tx.init(params))
    mesh = jax_make_mesh(JaxParallelConfig(), jax.devices()[:2])
    jstep = jax_sharded_step(JaxModel(jcfg), jcfg, tx, mesh, video=video)
    jbatch = jax_synthetic_batch(jcfg, B, hw=(H, W), two_frame=video, seed=0)
    jax_metrics = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        jax_metrics.append({k: float(v) for k, v in jm.items()})
    return {"ranks": ranks.wait(), "jax_metrics": jax_metrics,
            "jax_params": flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params)),
            "init_params": flatten_tree(variables["params"]), "cfg": pexp.model}


def test_dp_losses_match_jax(runs):
    for r, rank in enumerate(runs["ranks"]):
        pm, jm = rank["metrics"], runs["jax_metrics"]
        for k in (k for k in jm[0] if k != "grad_norm"):
            np.testing.assert_allclose(pm[0][k], jm[0][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(pm[1]["total_loss"], jm[1]["total_loss"], rtol=1e-3)
        assert pm[0]["skipped_nonfinite"] == 0.0


def test_dp_params_match_jax(runs):
    jp, p0 = runs["jax_params"], runs["init_params"]
    pp = flatten_tree(to_jax_variables(runs["ranks"][0]["params"], runs["cfg"])["params"])
    assert set(jp) == set(pp)
    a = np.concatenate([pp[k].ravel() for k in jp])
    b = np.concatenate([jp[k].ravel() for k in jp])
    assert np.linalg.norm(a - b) <= 1e-6 * np.sqrt(a.size) + 1e-3 * np.linalg.norm(b)
    moved = 0
    for k in jp:
        delta = jp[k] - p0[k]
        if not delta.any():  # frozen: unchanged on both sides
            np.testing.assert_array_equal(pp[k], p0[k], err_msg=k)
            continue
        moved += 1
        assert np.linalg.norm(pp[k] - jp[k]) < 0.1 * np.linalg.norm(delta), k
    assert moved > 300


def test_dp_ranks_bit_identical(runs):
    r0, r1 = runs["ranks"]
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["params"]) == set(r1["params"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
