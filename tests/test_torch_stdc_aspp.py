"""The STDC backbones and the ASPP semantic head of the port against the JAX
package's, on the CPU.

Weights: a seeded port model (``build_model(generator=...)``, BN statistics
redrawn away from identity) bridged to JAX (``to_jax_variables``) and back
(``from_jax_variables``), so both sides run the same numbers.

Tolerances: the STDC feature maps (STDCNet813 and 1446 at 64x128, and the
Add-bottleneck net) within
1e-5 of each map's largest magnitude (f32 convolutions summed in another
order); the ``debug_tiny`` ``stdc813`` + ASPP model's losses, each within
rtol 1e-4 (atol 1e-6), and its gradients, every trainable leaf within atol
1e-6 + rtol 1e-3 of the leaf's largest magnitude, as
``tests/test_torch_train_grads.py`` holds ResNet's; the key mapping
exactly.
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
from polyphonicformer_tpu.models.stdc import STDCNet as JaxSTDCNet
from polyphonicformer_tpu.train.losses import compute_losses as jax_compute_losses
from polyphonicformer_tpu.train.optim import lr_mult as jax_lr_mult
from polyphonicformer_torch.configs import STDC_LAYERS, model_preset, preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.infer.pipeline import make_image_step
from polyphonicformer_torch.models import PolyphonicFormer, build_model
from polyphonicformer_torch.train.losses import compute_losses
from polyphonicformer_torch.train.optim import Optimizer
from polyphonicformer_torch.weights import (_mapping, flatten_tree, from_jax_variables,
                                            to_jax_variables, to_numpy_state_dict)

H, W = 64, 128
ASPP = dict(with_semantic_aspp=True, aspp_dilations=(1, 2, 4))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(name="debug_tiny", **kw):
    return model_preset(name, **kw), dataclasses.replace(get_preset(name).model, **kw)


def _bridged(pcfg, seed=0):
    """(port model, JAX variables) with the same weights: drawn for the port,
    BN statistics redrawn, to JAX and back through the bridge."""
    model = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    variables = to_jax_variables(to_numpy_state_dict(model), pcfg)
    return build_model(pcfg, "cpu", state_dict=from_jax_variables(variables, pcfg)), variables


@pytest.mark.parametrize("backbone", sorted(STDC_LAYERS))
def test_stdc_backbone_matches_jax(backbone):
    pcfg, _ = _configs(backbone=backbone)
    model, variables = _bridged(pcfg)
    img = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    jax_vars = {c: variables[c]["backbone"] for c in ("params", "batch_stats")}
    want = JaxSTDCNet(layers=STDC_LAYERS[backbone]).apply(
        jax.tree_util.tree_map(jnp.asarray, jax_vars), jnp.asarray(img))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(1, c, H // s, W // s) for c, s in
                                             zip((64, 256, 512, 1024), (4, 8, 16, 32))]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), i


def test_add_bottleneck_net_matches_jax():
    """The Add-bottleneck STDCNet (``block_type="add"``, no model path builds
    it) at 64x128, JAX weights drawn from a seed and carried by name (the
    port's module names are the flax names)."""
    from polyphonicformer_torch.models.layers import FrozenBatchNorm
    from polyphonicformer_torch.models.stdc import STDCNet

    img = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    jmod = JaxSTDCNet(layers=(2, 2, 2), block_type="add")
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), img))
    rng = np.random.RandomState(1)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "var":
            return 0.5 + rng.rand(*s.shape)
        return (name == "scale") + 0.1 * rng.randn(*s.shape)

    variables = jax.tree_util.tree_map_with_path(
        lambda path, s: draw(path, s).astype(np.float32), shapes)
    port = STDCNet(layers=(2, 2, 2), block_type="add")
    bns = {n for n, m in port.named_modules() if isinstance(m, FrozenBatchNorm)}
    sd = {}
    for key in port.state_dict():
        *mod, leaf = key.split(".")
        coll = "batch_stats" if leaf.startswith("running") else "params"
        node = variables[coll]
        for part in mod:
            node = node[part]
        if ".".join(mod) in bns:
            v = node[{"weight": "scale", "bias": "bias", "running_mean": "mean",
                      "running_var": "var"}[leaf]]
        else:
            v = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.ascontiguousarray(v))
    port.load_state_dict(sd, strict=True)
    want = jmod.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, i
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), i


@pytest.mark.parametrize("backbone,aspp", [("stdc813", True), ("stdc1446", False),
                                           ("resnet50", True)])
def test_keys_round_trip_and_match_the_jax_tree(backbone, aspp):
    """The port's keys are the mapping's, the mapping's paths and shapes the
    JAX model's (``jax.eval_shape``), and port -> JAX -> port gives back
    every value."""
    kw = dict(backbone=backbone, **(ASPP if aspp else {}))
    pcfg, jcfg = _configs("debug_tiny_video", **kw)
    model = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    sd = to_numpy_state_dict(model)
    mapping = _mapping(pcfg)
    assert set(sd) == {key for key, _ in mapping.values()} and len(sd) == len(mapping)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), method=JaxModel.init_all))
    variables = to_jax_variables(sd, pcfg)
    for coll in ("params", "batch_stats"):
        want = {k: v.shape for k, v in flatten_tree(shapes[coll]).items()}
        assert {k: v.shape for k, v in flatten_tree(variables[coll]).items()} == want, coll
    back = from_jax_variables(variables, pcfg)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
    keys = set(sd)
    assert any(k.startswith("rpn_head.semantic_aspp.branch1_conv") for k in keys) == aspp
    if backbone.startswith("stdc"):
        assert "backbone.stage0_0.conv1.conv.weight" in keys
        assert "backbone.stage0_0.avd_bn.running_var" in keys


@pytest.fixture(scope="module")
def grads():
    """The debug_tiny stdc813 + ASPP losses and gradients, port and JAX
    (``jax.value_and_grad``, compiled once)."""
    pcfg, jcfg = _configs(backbone="stdc813", **ASPP)
    pexp = dataclasses.replace(preset("debug_tiny"), model=pcfg)
    model, variables = _bridged(pcfg, seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    consts = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_synthetic_batch(jcfg, 1, hw=(H, W), seed=0))

    def loss_fn(p):
        out = JaxModel(jcfg).apply({"params": p, **consts}, jbatch.image)
        return jax_compute_losses(jcfg, out, jbatch.gt)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model.train()
    batch = synthetic_batch(pcfg, 1, (H, W), seed=0, device="cpu")
    total, losses = compute_losses(pcfg, model(batch.image), batch.gt)
    total.backward()
    pgrads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
              if p.grad is not None}
    return dict(jax_total=float(jtotal), port_total=float(total.detach()),
                jax_losses={k: float(v) for k, v in jlosses.items()},
                port_losses={k: float(v.detach()) for k, v in losses.items()},
                jax=flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads)),
                port=flatten_tree(to_jax_variables(pgrads, pcfg, partial=True)["params"]),
                pexp=pexp, model=model)


def test_losses_match_jax(grads):
    jl, pl = grads["jax_losses"], grads["port_losses"]
    assert set(pl) == set(jl) and "loss_aspp_semseg" in pl
    assert pl["loss_aspp_semseg"] > 0
    for k, v in jl.items():
        np.testing.assert_allclose(pl[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(grads["port_total"], grads["jax_total"], rtol=1e-4)


def test_every_gradient_matches_jax(grads):
    """STDC freezes nothing (no ``conv1``, ``bn1`` or ``layer{s}`` module),
    so every leaf has a gradient on both sides; the ASPP head's included."""
    jg, pg = grads["jax"], grads["port"]
    assert set(pg) == set(jg)
    assert any(k.startswith("rpn_head/semantic_aspp/") for k in pg)
    assert np.abs(pg["rpn_head/semantic_aspp/branch2_conv/kernel"]).max() > 0
    for k, g in pg.items():
        want = jg[k]
        assert np.isfinite(g).all(), k
        assert np.abs(g - want).max() <= 1e-6 + 1e-3 * np.abs(want).max(), k


def test_optimizer_groups_match_jax(grads):
    """Every STDC parameter trains, at the learning-rate multiplier JAX's
    ``lr_mult`` gives its flax path (the backbone's)."""
    pexp, model = grads["pexp"], grads["model"]
    mult = pexp.schedule.backbone_lr_mult
    opt = Optimizer(model, pexp.schedule)
    assert len(opt.params) == sum(1 for _ in model.parameters())
    group = {id(p): g["initial_lr"] / pexp.schedule.lr for g in opt.adamw.param_groups
             for p in g["params"]}
    params = dict(model.named_parameters())
    for path, (key, _) in _mapping(pexp.model).items():
        if not path.startswith("BATCHSTATS::"):
            assert group[id(params[key])] == jax_lr_mult(path, mult), path
    assert set(group.values()) == {1.0, mult}


def test_serving_skips_the_aspp_map():
    """The serving step runs on an STDC + ASPP model and never computes the
    ASPP map (JAX's jitted steps drop it as dead code); the forward does."""
    pcfg, _ = _configs("debug_tiny_video", backbone="stdc813", **ASPP)
    model = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    model.rpn_head.semantic_aspp.register_forward_hook(lambda *a: calls.append(1))
    img = torch.from_numpy(np.random.RandomState(1).randn(1, H, W, 3).astype(np.float32))
    with torch.no_grad():
        pano = make_image_step(model, pcfg, (H, W))(img)
        assert pano.semantic.shape == (H, W) and not calls
        assert model(img).rpn.aspp_seg_preds.shape == (1, 19, H // 8, W // 8) and calls
    with torch.device("meta"):
        assert PolyphonicFormer(pcfg).remat_backbone is False  # JAX remats no STDC
