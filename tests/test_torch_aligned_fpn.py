"""The flow-aligned FPN of the port (``models/aligned_fpn.py``,
``ops/grid_sample.py``, ``ops/deform_conv.py``) against the JAX package's,
on the CPU, standalone as the JAX ``tests/test_alt_backbones.py`` runs it.

Inputs and parameters are seeded numpy draws: every flax parameter (the
deformable conv's offset conv included, which the reference
zero-initialises, so that the taps really move) and BN statistics away from
identity, carried to the port's modules, whose names are the flax names.

Tolerances: ``grid_sample_bilinear`` and ``flow_warp`` (``F.grid_sample``
against JAX's gathers) within 1e-5, as the JAX test holds its gathers to
``F.grid_sample``; ``DeformConv2d`` and ``UperNetAlignHead`` v1 and v2
within 1e-5 of the output's largest magnitude (f32 products summed in
another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.models.aligned_fpn import UperNetAlignHead as JaxHead
from polyphonicformer_tpu.ops.deform_conv import DeformConv2d as JaxDeformConv2d
from polyphonicformer_tpu.ops.grid_sample import flow_warp as jax_flow_warp
from polyphonicformer_tpu.ops.grid_sample import grid_sample_bilinear as jax_grid_sample
from polyphonicformer_torch.models.aligned_fpn import UperNetAlignHead
from polyphonicformer_torch.models.layers import FrozenBatchNorm
from polyphonicformer_torch.ops.deform_conv import DeformConv2d
from polyphonicformer_torch.ops.grid_sample import flow_warp, grid_sample_bilinear

LEVELS = ((64, 16, 32), (128, 8, 16), (256, 4, 8), (512, 2, 4))  # (C, h, w), strides 4-32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _draw(shapes, seed):
    """Seeded values for a flax variable tree of shapes: kernels at 1/sqrt
    of their fan-in, BN variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if name in ("kernel", "weight"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(module, variables):
    """Flax variables -> the port module, by name: kernels (kh, kw, I, O)
    -> (O, I, kh, kw), BN scale / bias / mean / var -> weight / bias /
    running stats."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    bns = {n for n, m in module.named_modules() if isinstance(m, FrozenBatchNorm)}
    sd = {}
    for key in module.state_dict():
        *mod, leaf = key.split(".")
        node, snode = params, stats
        for part in mod:
            node, snode = node.get(part, {}), snode.get(part, {})
        if ".".join(mod) in bns:
            v = {"weight": node.get("scale"), "bias": node.get("bias"),
                 "running_mean": snode.get("mean"), "running_var": snode.get("var")}[leaf]
        elif leaf == "weight" and "kernel" in node:
            v = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        elif leaf == "weight":  # the deformable conv's own (k, k, C, O) weight
            v = np.asarray(node["weight"]).transpose(3, 2, 0, 1)
        else:
            v = node[leaf]
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
    module.load_state_dict(sd, strict=True)
    return module


def test_grid_sample_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 8, 12, 5).astype(np.float32)
    grid = (rng.rand(2, 6, 10, 2) * 2.4 - 1.2).astype(np.float32)  # some taps outside
    want = jax.vmap(jax_grid_sample)(jnp.asarray(feat), jnp.asarray(grid))
    got = grid_sample_bilinear(_nchw(feat), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), atol=1e-5)


def test_flow_warp_matches_jax():
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 8, 12, 3).astype(np.float32)
    flow = (rng.randn(2, 16, 24, 2) * 2).astype(np.float32)  # warped up to 2x
    want = jax_flow_warp(jnp.asarray(feat), jnp.asarray(flow), (16, 24))
    got = flow_warp(_nchw(feat), _nchw(flow), (16, 24))
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), atol=1e-5)


def test_deform_conv_matches_jax():
    x = np.random.RandomState(2).randn(2, 7, 9, 6).astype(np.float32)
    mod = JaxDeformConv2d(5)
    variables = _draw(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x)), seed=3)
    want = _nchw(mod.apply(variables, jnp.asarray(x))).numpy()
    port = _load(DeformConv2d(6, 5), variables)
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
        offsets = port.conv_offset(_nchw(x)).abs()
    assert float(offsets.max()) > 1.0  # taps move by more than a pixel
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("align_type", ["v1", "v2"])
def test_upernet_align_head_matches_jax(align_type):
    rng = np.random.RandomState(4)
    feats = [rng.randn(1, h, w, c).astype(np.float32) for c, h, w in LEVELS]
    head = JaxHead(out_channels=64, align_type=align_type)
    variables = _draw(jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), feats)), seed=5)
    want = _nchw(head.apply(variables, [jnp.asarray(f) for f in feats])).numpy()
    port = _load(UperNetAlignHead([c for c, _, _ in LEVELS], 64, align_type), variables)
    with torch.no_grad():
        got = port([_nchw(f) for f in feats]).numpy()
    assert got.shape == (1, 64, 8, 16)  # the stride-8 fused map
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
