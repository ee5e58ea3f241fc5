"""The training slice's host and loss code against the JAX package on the
CPU: the synthetic batch, the assignment, the targets, ``compute_losses``
on identical model outputs, the learning-rate schedule and the optimizer.

Model outputs are drawn with numpy from a seed at the ``debug_tiny`` widths
(20 proposals + 11 stuff rows, 3 stages, 8x16 logits for 32x64 GT) and
handed to both sides; the JAX functions run as compiled XLA on the CPU.
"""
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from polyphonicformer_tpu.configs import ScheduleConfig as JaxScheduleConfig
from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.data.loader import synthetic_batch as jax_synthetic_batch
from polyphonicformer_tpu.models.kernel_head import RPNOutput as JaxRPN
from polyphonicformer_tpu.models.kernel_update_head import StageOutput as JaxStage
from polyphonicformer_tpu.models.polyphonic import ModelOutput as JaxOut
from polyphonicformer_tpu.train import assign as jax_assign
from polyphonicformer_tpu.train import losses as jax_losses
from polyphonicformer_tpu.train import optim as jax_optim
from polyphonicformer_torch.configs import ScheduleConfig, preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models.kernel_head import RPNOutput
from polyphonicformer_torch.models.kernel_update_head import StageOutput
from polyphonicformer_torch.models.polyphonic import ModelOutput
from polyphonicformer_torch.train import losses, optim
from polyphonicformer_torch.train.assign import solve_assignments_lockstep

H, W = 64, 128  # image; GT at stride 4, logits at stride 8


def _cfgs(**model_changes):
    jcfg = dataclasses.replace(get_preset("debug_tiny").model, **model_changes)
    pcfg = dataclasses.replace(preset("debug_tiny").model, **model_changes)
    return jcfg, pcfg


def _outputs(cfg, b=2, seed=0):
    """Random model outputs of the fields compute_losses reads, both sides."""
    rng = np.random.RandomState(seed)
    h, w = H // 8, W // 8
    q, nc = cfg.num_queries, cfg.num_classes

    def f32(*shape, scale=3.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    rpn_masks, seg, depth0 = f32(b, q, h, w), f32(b, h, w, nc), f32(b, h, w)
    stages = [(f32(b, q, nc), f32(b, q, h, w), f32(b, q, h, w)) for _ in range(cfg.num_stages)]
    j = jnp.asarray
    jout = JaxOut(
        rpn=JaxRPN(None, None, j(rpn_masks), None, j(seg), None, None, j(depth0)),
        stages=tuple(JaxStage(j(c), j(m), None, j(d), None) for c, m, d in stages))
    t = torch.from_numpy
    pout = ModelOutput(
        rpn=RPNOutput(None, None, t(rpn_masks), None, t(seg).permute(0, 3, 1, 2), None, None,
                      t(depth0)),
        stages=tuple(StageOutput(t(c), t(m), None, t(d), None) for c, m, d in stages))
    return jout, pout


def _batches(cfg, b=2, seed=0, **kw):
    jb = jax_synthetic_batch(cfg, b, hw=(H, W), seed=seed, **kw)
    pb = synthetic_batch(cfg, b, (H, W), seed=seed, device="cpu", **kw)
    return jb, pb


@pytest.mark.parametrize("kw", [dict(), dict(max_instances=6, seed=3),
                                dict(two_frame=True, seed=1)])
def test_synthetic_batch_is_bit_equal(kw):
    jcfg, _ = _cfgs()
    jb, pb = _batches(jcfg, **kw)
    np.testing.assert_array_equal(pb.image.numpy(), jb.image)
    for name in pb.gt._fields:
        np.testing.assert_array_equal(getattr(pb.gt, name).numpy(), getattr(jb.gt, name),
                                      err_msg=name)
    if kw.get("two_frame"):
        np.testing.assert_array_equal(pb.ref_image.numpy(), jb.ref_image)
        for name in pb.ref_gt._fields:
            np.testing.assert_array_equal(getattr(pb.ref_gt, name).numpy(),
                                          getattr(jb.ref_gt, name), err_msg=name)


def _jax_assign_shared(cfg, out, gt):
    """The JAX package's shared-branch matching (train/losses.py:281-311)."""
    b, np_, nt, s = gt.thing_valid.shape[0], cfg.num_proposals, cfg.num_thing_classes, \
        cfg.num_stages
    acfg = cfg.rcnn_assigner
    up = jax_losses._upsample2(jnp.stack([out.rpn.mask_preds] + [so.mask_preds
                                                                 for so in out.stages]))
    cls = jnp.stack([so.cls_score for so in out.stages])
    costs = jax_assign.mask_dice_costs_stacked(acfg, up[:s, :, :np_], gt)
    cls_c = jax.vmap(jax.vmap(lambda c, l: jax_assign.focal_cls_cost(
        c, l, acfg.focal_gamma, acfg.focal_alpha)), in_axes=(0, None))(
        cls[:s - 1, :, :np_, :nt], gt.thing_labels)
    costs = costs.at[1:].add(acfg.cls_weight * cls_c)
    res = jax_assign.solve_assignments_lockstep(costs.reshape((s * b,) + costs.shape[2:]),
                                                jnp.tile(gt.thing_valid, (s, 1)))
    return res.pred2gt.reshape(s, b, -1), res.gt2pred.reshape(s, b, -1)


def test_assignments_equal_jax():
    """Every problem of the shared rpn/stage-0 branch: pred2gt and gt2pred
    equal to the JAX package's (one batched solve on each side)."""
    jcfg, pcfg = _cfgs()
    jout, pout = _outputs(jcfg)
    jb, pb = _batches(jcfg, max_instances=7)
    want_p2g, want_g2p = (np.asarray(a) for a in jax.jit(
        lambda o, g: _jax_assign_shared(jcfg, o, g))(jout, jb.gt))
    asg = losses.assign(pcfg, pout, pb.gt)
    assert len(asg.assigns) == 1 + pcfg.num_stages
    assert asg.assigns[0].pred2gt is asg.assigns[1].pred2gt  # rpn shares problem 0
    for s in range(pcfg.num_stages):
        np.testing.assert_array_equal(asg.assigns[s + 1].pred2gt.numpy(), want_p2g[s])
        np.testing.assert_array_equal(asg.assigns[s + 1].gt2pred[:, 0].numpy(), want_g2p[s])
    assert (want_g2p >= 0).sum() > 0


def test_topk_assignment_equals_jax():
    """topk > 1: the multi-round matching of ``solve_assignment``."""
    rng = np.random.RandomState(4)
    costs = rng.randn(3, 20, 6).astype(np.float32)
    valid = rng.rand(3, 6) > 0.3
    want = jax.vmap(lambda c, v: jax_assign.solve_assignment(c, v, 20, topk=3))(
        jnp.asarray(costs), jnp.asarray(valid))
    got = solve_assignments_lockstep(torch.from_numpy(costs), torch.from_numpy(valid), topk=3)
    np.testing.assert_array_equal(got.pred2gt.numpy(), np.asarray(want.pred2gt))
    np.testing.assert_array_equal(got.gt2pred.numpy(), np.asarray(want.gt2pred))


@pytest.mark.parametrize("branch", ["shared", "general_topk2"])
def test_compute_losses_matches_jax(branch):
    """Every key of the loss dict and the total within rtol 1e-5 (f32 sums
    in another order) on identical model outputs.  ``shared`` is the default
    configuration (one batched solve, K6 plain for the mask losses);
    ``general_topk2`` gives the rpn its own assigner with two matching
    rounds, the JAX general branch."""
    changes = {}
    if branch == "general_topk2":
        changes = dict(rpn_assigner=dataclasses.replace(get_preset("debug_tiny").model
                                                        .rpn_assigner, topk=2))
    jcfg, pcfg = _cfgs(**changes)
    jout, pout = _outputs(jcfg, seed=1)
    jb, pb = _batches(jcfg, seed=2, max_instances=6)
    jtotal, jl = jax.jit(lambda o, g: jax_losses.compute_losses(jcfg, o, g))(jout, jb.gt)
    total, pl = losses.compute_losses(pcfg, pout, pb.gt)
    assert set(pl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert all(losses.is_metric_key(k) == jax_losses.is_metric_key(k) for k in jl)


def test_compute_losses_refuses_what_is_not_ported():
    _, pcfg = _cfgs()
    _, pout = _outputs(pcfg)
    gt = synthetic_batch(pcfg, 2, (H, W), device="cpu").gt
    with pytest.raises(NotImplementedError):
        losses.compute_losses(dataclasses.replace(pcfg, with_semantic_aspp=True), pout, gt)
    with pytest.raises(NotImplementedError):
        losses.compute_losses(dataclasses.replace(pcfg, ignore_label=254), pout, gt)


def test_lr_schedule_matches_jax():
    """rtol 2e-5: the JAX schedule is evaluated in f32, the port's in
    double (the warmup factor at step 0 is 1.0000129e-3 in f32)."""
    cfg = ScheduleConfig(lr=1e-4)
    jsched = jax_optim.make_lr_schedule(JaxScheduleConfig(lr=1e-4), steps_per_epoch=100)
    sched = optim.make_lr_schedule(cfg, steps_per_epoch=100)
    for t in (0, 1, 500, 999, 1000, 1599, 1600, 2199, 2200, 5000):
        np.testing.assert_allclose(sched(t), float(jsched(t)), rtol=2e-5)


def test_frozen_names_match_jax():
    """is_frozen and lr_mult on the port's names equal the JAX functions on
    the bridged paths, and the model's requires_grad flags agree."""
    from polyphonicformer_torch.models.polyphonic import PolyphonicFormer
    from polyphonicformer_torch.weights import build_param_mapping

    cfg = preset("debug_tiny").model
    with torch.device("meta"):
        model = PolyphonicFormer(cfg)
    by_key = {key: path for path, (key, _) in build_param_mapping().items()}
    names = dict(model.named_parameters())
    for name, p in names.items():
        path = by_key[name]
        assert optim.is_frozen(name) == jax_optim.is_frozen(path), name
        assert optim.lr_mult(name, 0.25) == jax_optim.lr_mult(path, 0.25), name
        assert p.requires_grad == (not optim.is_frozen(name)), name
    assert sum(not p.requires_grad for p in names.values()) == 33


class _Leaf(nn.Module):
    def __init__(self, shape, rng):
        super().__init__()
        self.weight = nn.Parameter(torch.from_numpy(rng.randn(*shape).astype(np.float32)))


def _toy_model(rng):
    """Parameters named like the model's: frozen stem and layer1, a backbone
    stage at lr_mult 0.25, a head at 1.0."""
    model = nn.Module()
    model.backbone = nn.ModuleDict({
        "conv1": _Leaf((4, 3), rng), "layer1": nn.ModuleDict({"0": _Leaf((5,), rng)}),
        "layer2": nn.ModuleDict({"0": _Leaf((6, 2), rng)})})
    model.head = _Leaf((3, 3), rng)
    model.backbone["conv1"].requires_grad_(False)
    model.backbone["layer1"].requires_grad_(False)
    return model


def test_optimizer_matches_optax_chain():
    """Five steps of the port's optimizer (clip + AdamW + LambdaLR) against
    the optax chain of JAX ``make_optimizer``, params within rtol 1e-6: with
    warmup and a decay step, a large gradient (the clip acts) and small
    ones (it does not), and frozen leaves that never move."""
    rng = np.random.RandomState(0)
    model = _toy_model(rng)
    jpath = {"backbone.conv1.weight": ("backbone", "conv1", "kernel"),
             "backbone.layer1.0.weight": ("backbone", "layer1_0", "kernel"),
             "backbone.layer2.0.weight": ("backbone", "layer2_0", "kernel"),
             "head.weight": ("head", "kernel")}
    params = {}
    for name, p in model.named_parameters():
        node = params
        *parents, leaf = jpath[name]
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy().copy())
    sched = dict(lr=1e-2, warmup_iters=3, warmup_ratio=0.1, lr_decay_epochs=(4,),
                 weight_decay=0.05)
    tx = jax_optim.make_optimizer(JaxScheduleConfig(**sched), params, steps_per_epoch=1)
    opt_state = tx.init(params)
    opt = optim.Optimizer(model, ScheduleConfig(**sched), steps_per_epoch=1)
    for step in range(5):
        scale = 10.0 if step == 1 else 0.05
        grads_np = {name: (rng.randn(*p.shape) * scale).astype(np.float32)
                    for name, p in model.named_parameters()}
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads_np[name].copy())
        jgrads = jax.tree_util.tree_map(lambda x: x, params)
        for name, g in grads_np.items():
            node = jgrads
            *parents, leaf = jpath[name]
            for k in parents:
                node = node[k]
            node[leaf] = jnp.asarray(g)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.clip_grads()
        opt.step()
        for name, p in model.named_parameters():
            node = params
            for k in jpath[name]:
                node = node[k]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(node), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} step {step}")
    assert np.array_equal(model.backbone["conv1"].weight.detach().numpy(),
                          np.asarray(params["backbone"]["conv1"]["kernel"]))


def test_loss_helpers_match_jax():
    """The loss functions of ``losses/`` on seeded inputs, rtol 1e-5."""
    import importlib

    from polyphonicformer_tpu.losses import cross_entropy as jce
    from polyphonicformer_tpu.losses import dice as jdice
    from polyphonicformer_tpu.losses import focal as jfocal
    from polyphonicformer_torch.losses import cross_entropy, depth_loss, dice, focal

    # the JAX package re-exports the function under the module's name
    jdl = importlib.import_module("polyphonicformer_tpu.losses.depth_loss")
    rng = np.random.RandomState(8)
    logits = (rng.randn(6, 5) * 2).astype(np.float32)
    labels = rng.randint(0, 6, 6).astype(np.int32)  # 5 = background
    weight = rng.rand(6).astype(np.float32)
    masks = (rng.randn(4, 8, 9) * 2).astype(np.float32)
    tgt = rng.rand(4, 8, 9).astype(np.float32)
    pix = (rng.rand(4, 8, 9) > 0.3).astype(np.float32)
    seg = (rng.randn(3, 7, 6) * 2).astype(np.float32)
    seg_lbl = rng.randint(0, 7, (3, 7)).astype(np.int32)
    seg_lbl[0, :3] = 255
    dpred = (rng.randn(2, 8, 9) * 2).astype(np.float32)
    dtgt = (rng.rand(2, 8, 9) * 90).astype(np.float32)
    dw = rng.rand(2, 8, 9).astype(np.float32) * (rng.rand(2, 8, 9) > 0.2)
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (jfocal.sigmoid_focal_loss(j(logits), j(labels), j(weight), 3.0),
         focal.sigmoid_focal_loss(t(logits), t(labels), t(weight), 3.0)),
        (jfocal.sigmoid_focal_loss(j(logits), j(labels)),
         focal.sigmoid_focal_loss(t(logits), t(labels))),
        (jce.masked_bce_mean(j(masks), j(tgt), j(pix)),
         cross_entropy.masked_bce_mean(t(masks), t(tgt), t(pix))),
        (jce.softmax_ce_ignore(j(seg), j(seg_lbl)), cross_entropy.softmax_ce_ignore(t(seg), t(seg_lbl))),
        (jdice.dice_loss_per_row(j(masks), j(tgt), j(pix)),
         dice.dice_loss_per_row(t(masks), t(tgt), t(pix))),
        (jdice.dice_loss_per_row(j(masks), j(tgt)), dice.dice_loss_per_row(t(masks), t(tgt))),
        (jdl.depth_loss_raw(j(dtgt[0] * 0.5 + 1), j(dtgt[0]), j(dw[0])),
         depth_loss.depth_loss_raw(t(dtgt[0] * 0.5 + 1), t(dtgt[0]), t(dw[0]))),
        (jdl.depth_loss(j(dpred[0]), j(dtgt[0]), j(dw[0]), loss_weight=5.0, si_weight=0.5),
         depth_loss.depth_loss(t(dpred[0]), t(dtgt[0]), t(dw[0]), loss_weight=5.0,
                               si_weight=0.5)),
        (jdl.depth_loss_stacked(j(dpred), j(dtgt), j(dw), depth_act_mode="monodepth"),
         depth_loss.depth_loss_stacked(t(dpred), t(dtgt), t(dw), depth_act_mode="monodepth")),
        (jdl.depth_loss_raw(j(dpred[0]), j(dtgt[0]), j(dw[0] * 0)),
         depth_loss.depth_loss_raw(t(dpred[0]), t(dtgt[0]), t(dw[0] * 0))),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7,
                                   err_msg=str(i))


def test_single_problem_assignment_equals_jax():
    from polyphonicformer_torch.train.assign import solve_assignment

    rng = np.random.RandomState(6)
    cost = rng.randn(20, 8).astype(np.float32)
    valid = rng.rand(8) > 0.3
    for topk in (1, 2):
        want = jax_assign.solve_assignment(jnp.asarray(cost), jnp.asarray(valid), 20, topk)
        got = solve_assignment(torch.from_numpy(cost), torch.from_numpy(valid), 20, topk)
        np.testing.assert_array_equal(got.pred2gt.numpy(), np.asarray(want.pred2gt))
        np.testing.assert_array_equal(got.gt2pred.numpy().reshape(np.shape(want.gt2pred)),
                                      np.asarray(want.gt2pred))
