"""Tensor-parallel Swin in the port on a (data=1, model=2) mesh of 2 gloo
ranks against the JAX package's ``make_tp_train_setup`` on a (1, 2) mesh,
on the CPU.

The narrow ``swin_tiny`` model of ``tests/test_swin_sharding.py::_tp_cfg``
(stage 0's 3 heads split 2 + 1), f32, the default schedule, 64x128, one
step on ``synthetic_batch(1, seed=0)``.  JAX initialises the weights; the
ranks load them through ``from_jax_variables`` and ``shard_state_dict``.

Tolerances, those of ``test_tp_train_step_gradient_parity``: the loss
dict within rtol 1e-4, the gathered parameters within rtol 5e-4, atol
5e-5; AdamW's first moments (0.1 x the clipped gradient) per leaf within
1e-3 of the leaf's L2 norm; the sharded backbone's forward within rtol
2e-5, atol 2e-5 of the JAX forward (``test_swin_backbone_model_sharding``).
The sharded leaves and their moments have the shard's shape; a checkpoint
gathers to the one-card format and restores into the shards exactly.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import ExperimentConfig as JaxExperimentConfig
from polyphonicformer_tpu.configs import ModelConfig as JaxModelConfig
from polyphonicformer_tpu.configs import ParallelConfig as JaxParallelConfig
from polyphonicformer_tpu.data.loader import synthetic_batch as jax_synthetic_batch
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.models.swin import SwinTransformer as JaxSwin
from polyphonicformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from polyphonicformer_tpu.parallel.mesh import shard_batch_pytree
from polyphonicformer_tpu.train.step import make_tp_train_setup as jax_tp_setup
from polyphonicformer_torch.configs import SWIN_SPECS
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.parallel.tensor_parallel import split_range
from polyphonicformer_torch.weights import (flatten_tree, from_jax_variables, gather_state_dict,
                                            shard_state_dict, to_jax_variables)
from tests.torch_dist_ranks import H, W, start_ranks, tp_model_config

TIMEOUT = 280


def _jax_cfg():
    mc = JaxModelConfig(backbone="swin_tiny", out_channels=64, in_channels=64,
                        fpn_out_channels=64, feedforward_channels=128, num_proposals=10,
                        max_things=4, remat_backbone=False, shard_backbone=True,
                        compute_dtype="float32")
    return JaxExperimentConfig(model=mc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("tp")
    jcfg = _jax_cfg()
    mesh = jax_make_mesh(JaxParallelConfig(num_data=1, num_model=2), jax.devices()[:2])
    model = JaxModel(jcfg.model)
    state, step, _ = jax_tp_setup(model, jcfg, mesh, (1, H, W, 3))
    init = jax.tree_util.tree_map(np.asarray, {"params": state.params, **state.consts})
    cfg = tp_model_config()
    full = from_jax_variables(init, cfg)
    torch.save(full, tmp / "full.pt")
    x = np.random.RandomState(1).randn(1, H, W, 3).astype(np.float32)
    torch.save(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), tmp / "image.pt")
    ranks = start_ranks(tmp, "tp_step", 2, TIMEOUT, parallel={"num_data": 1, "num_model": 2},
                        state_dict=str(tmp / "full.pt"), image=str(tmp / "image.pt"),
                        work_dir=str(tmp / "work"))
    jax_feats = JaxSwin(*SWIN_SPECS["swin_tiny"]).apply(
        {"params": init["params"]["backbone"]}, jnp.asarray(x))
    batch = jax_synthetic_batch(jcfg.model, 1, hw=(H, W), seed=0)
    state, metrics = step(state, shard_batch_pytree(mesh, batch))
    mu = [s for s in state.opt_state if hasattr(s, "mu")][0].mu
    return {"ranks": ranks.wait(), "cfg": cfg, "full": full,
            "jax_metrics": {k: float(v) for k, v in metrics.items()},
            "jax_params": flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)),
            "jax_mu": flatten_tree(jax.tree_util.tree_map(np.asarray, mu)),
            "jax_feats": [np.asarray(f) for f in jax_feats]}


def _gathered(runs, part, moment=None):
    """The full dict of ``part`` (``params``; ``moments`` of one kind,
    keyed by parameter name) from the ranks' shards."""
    shards = [r[part] for r in runs["ranks"]]
    if moment is not None:
        shards = [{k.rsplit("/", 1)[0]: v for k, v in sh.items() if k.endswith("/" + moment)}
                  for sh in shards]
    return gather_state_dict(shards, runs["cfg"])


def test_tp_loss_and_grad_norm_match_jax(runs):
    jm = runs["jax_metrics"]
    for r, rank in enumerate(runs["ranks"]):
        for k in jm:  # no frozen parameter in a Swin model: grad_norm compares too
            np.testing.assert_allclose(rank["metrics"][k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
    assert runs["ranks"][0]["metrics"] == runs["ranks"][1]["metrics"]


def test_tp_params_and_moments_match_jax(runs):
    params = flatten_tree(to_jax_variables(_gathered(runs, "params"), runs["cfg"])["params"])
    assert set(params) == set(runs["jax_params"])
    for k, want in runs["jax_params"].items():
        np.testing.assert_allclose(params[k], want, rtol=5e-4, atol=5e-5, err_msg=k)
    mu = _gathered(runs, "moments", "exp_avg")
    mu = flatten_tree(to_jax_variables(mu, runs["cfg"], partial=True)["params"])
    assert set(mu) == set(runs["jax_mu"])
    for k, want in runs["jax_mu"].items():
        assert np.linalg.norm(mu[k] - want) <= 1e-3 * np.linalg.norm(want) + 1e-12, k


def test_tp_forward_matches_jax(runs):
    for r, rank in enumerate(runs["ranks"]):
        for got, want in zip(rank["feats"], runs["jax_feats"]):
            np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {r}")


def test_tp_shards_have_shard_shapes(runs):
    full, cfg = runs["full"], runs["cfg"]
    embed, _, heads = SWIN_SPECS[cfg.backbone]
    for r, rank in enumerate(runs["ranks"]):
        sharded = [k for k, kind in rank["layout"].items() if kind == "sharded"]
        assert len(sharded) == 6 * sum(SWIN_SPECS[cfg.backbone][1])
        for k in sharded:
            shape = rank["params"][k].shape
            assert shape != tuple(full[k].shape), k
            assert rank["moments"][f"{k}/exp_avg"].shape == shape, k
            assert rank["moments"][f"{k}/exp_avg_sq"].shape == shape, k
        qkv = rank["params"]["backbone.stages.0.blocks.0.attn.w_msa.qkv.weight"]
        local = split_range(heads[0], 2, r)[1]  # 3 heads: 2 + 1
        assert qkv.shape == (3 * local * embed // heads[0], embed)
        partial = [k for k, kind in rank["layout"].items() if kind == "partial"]
        assert partial and all(k.endswith("relative_position_bias_table") for k in partial)


def test_tp_checkpoint_gathers_and_restores(runs):
    r0, r1 = runs["ranks"]
    ckpt = torch.load(r0["ckpt"], weights_only=True)
    want = _gathered(runs, "params")
    assert set(ckpt["model"]) == set(want)
    for k, v in ckpt["model"].items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    one_card = dataclasses.replace(runs["cfg"], shard_backbone=False)
    build_model(one_card, "cpu", state_dict=ckpt["model"])  # the one-card format, strict
    for rank in (r0, r1):
        assert rank["restored_step"] == 1
        for k, v in rank["params"].items():
            np.testing.assert_array_equal(rank["restored"][k], v, err_msg=k)
        for k, v in rank["moments"].items():
            np.testing.assert_array_equal(rank["restored_moments"][k], v, err_msg=k)


@pytest.mark.parametrize("num_model", [2, 3, 4])
def test_shard_then_gather_is_identity(num_model):
    cfg = tp_model_config()
    full = build_model(dataclasses.replace(cfg, shard_backbone=False), "cpu",
                       generator=torch.Generator().manual_seed(0)).state_dict()
    shards = [shard_state_dict(full, cfg, r, num_model) for r in range(num_model)]
    got = gather_state_dict(shards, cfg)
    assert set(got) == set(full)
    for k in full:
        assert torch.equal(got[k], full[k]), k
    qkv = "backbone.stages.3.blocks.1.attn.w_msa.qkv.weight"
    assert sum(sh[qkv].shape[0] for sh in shards) == full[qkv].shape[0]
