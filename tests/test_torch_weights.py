"""The weight bridge between the JAX package's variables and the port's
state_dict, and the port's independence from JAX and the JAX package."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools import convert_torch_ckpt as jax_ckpt
from polyphonicformer_tpu.tools.convert_torch_ckpt import (
    build_param_mapping,
    convert_state_dict,
    flatten_tree,
)
from polyphonicformer_torch import weights
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import PolyphonicFormer, build_model
from polyphonicformer_torch.weights import (from_jax_variables, to_jax_variables,
                                            to_numpy_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tree():
    """The tiny video model's variable tree (shapes from jax.eval_shape,
    no compile), filled with seeded numpy values."""
    cfg = get_preset("debug_tiny_video").model
    shapes = jax.eval_shape(lambda: JaxModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)), method=JaxModel.init_all))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                  shapes)
    return cfg, model_preset("debug_tiny_video"), jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.mark.parametrize("preset", ["video_r50_1x", "debug_tiny_video", "video_swinl"])
def test_state_dict_keys_are_reference_keys(preset):
    """590 keys for R50 + 3 stages + track head (658 on Swin-L), exactly the
    mapping's."""
    cfg = get_preset(preset).model
    with torch.device("meta"):
        model = PolyphonicFormer(model_preset(preset))
    mapping = build_param_mapping(cfg.num_stages, cfg.backbone, cfg.with_track)
    assert set(model.state_dict()) == {key for key, _ in mapping.values()}
    want = {"video_r50_1x": 590, "video_swinl": 658}.get(preset)
    assert want is None or len(model.state_dict()) == want


def test_bridge_loads_strict_and_round_trips(jax_tree):
    cfg, pcfg, tree = jax_tree
    sd = from_jax_variables(tree, pcfg)
    model = build_model(pcfg, "cpu", state_dict=sd)  # load_state_dict(strict=True)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = convert_state_dict(to_numpy_state_dict(model), cfg)
    for coll in ("params", "batch_stats"):
        want, got = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert set(want) == set(got)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_track_fc0_is_the_c_major_flatten(jax_tree):
    """track_head.fcs.0 takes the NCHW RoI features flattened C-major: the
    JAX kernel row for (y, x, c) is the port's column c*49 + y*7 + x."""
    _, pcfg, tree = jax_tree
    sd = from_jax_variables(tree, pcfg)
    kernel = tree["params"]["track_head"]["embed_mlp"]["fc0"]["kernel"]  # (49*C, O)
    c = kernel.shape[0] // 49
    y, x, ch = 3, 5, c - 2
    np.testing.assert_array_equal(sd["track_head.fcs.0.weight"][:, ch * 49 + y * 7 + x].numpy(),
                                  kernel[(y * 7 + x) * c + ch])


@pytest.mark.parametrize("preset", ["video_r50_1x", "image_r50_2x", "debug_tiny_video",
                                    "video_swinl", "swin_tiny"])
def test_mapping_copy_equals_the_jax_tool(preset):
    """The port's copy of the key mapping is the JAX tool's, entry for entry
    (key and transform); ``swin_tiny`` is debug_tiny_video on that backbone."""
    if preset == "swin_tiny":
        cfg = dataclasses.replace(get_preset("debug_tiny_video").model, backbone=preset)
    else:
        cfg = get_preset(preset).model
    args = (cfg.num_stages, cfg.backbone, cfg.with_track, cfg.num_cls_fcs, cfg.num_mask_fcs)
    assert weights.build_param_mapping(*args) == jax_ckpt.build_param_mapping(*args)


@pytest.mark.parametrize("kind", ["copy", "conv", "linear", "squeeze11", "linear_chw2hwc_7",
                                  "linear_chw2hwc_2", "vec_chw2hwc_2"])
def test_transforms_equal_the_jax_tool(kind):
    rng = np.random.RandomState(1)
    shape = {"copy": (5,), "conv": (4, 3, 3, 2), "linear": (6, 5), "squeeze11": (7, 3, 1, 1),
             "linear_chw2hwc_7": (6, 3 * 49), "linear_chw2hwc_2": (6, 5 * 4),
             "vec_chw2hwc_2": (5 * 4,)}[kind]
    torch_side = rng.randn(*shape).astype(np.float32)
    jax_side = jax_ckpt._transform(torch_side, kind)
    np.testing.assert_array_equal(weights._transform(torch_side, kind), jax_side)
    np.testing.assert_array_equal(weights._inverse_transform(jax_side, kind),
                                  jax_ckpt._inverse_transform(jax_side, kind))


def test_to_jax_variables_equals_convert_state_dict(jax_tree):
    _, pcfg, tree = jax_tree
    sd = {k: v.numpy() for k, v in from_jax_variables(tree, pcfg).items()}
    got, want = to_jax_variables(sd, pcfg), convert_state_dict(sd, get_preset("debug_tiny_video").model)
    for coll in ("params", "batch_stats"):
        g, w = weights.flatten_tree(got[coll]), flatten_tree(want[coll])
        assert set(g) == set(w)
        for path in w:
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)
    assert weights.unflatten_tree(weights.flatten_tree(tree["params"])).keys() == tree["params"].keys()


@pytest.mark.parametrize("backbone", ["swin_tiny", "swin_large"])
def test_swin_bridge_round_trips_strict(backbone):
    """Port -> JAX -> port on a Swin model loads with ``strict=True`` and
    gives back every value; the JAX side equals ``convert_state_dict``.
    swin_tiny: the debug widths, seeded weights.  swin_large: the
    ``video_swinl`` model (195M backbone parameters), so each leaf is a
    cheap counting pattern instead of a draw."""
    if backbone == "swin_tiny":
        pcfg = model_preset("debug_tiny_video", backbone=backbone)
        jcfg = dataclasses.replace(get_preset("debug_tiny_video").model, backbone=backbone)
        sd = to_numpy_state_dict(build_model(pcfg, "cpu",
                                             generator=torch.Generator().manual_seed(0)))
    else:
        pcfg, jcfg = model_preset("video_swinl"), get_preset("video_swinl").model
        with torch.device("meta"):
            shapes = PolyphonicFormer(pcfg).state_dict()
        sd = {k: (np.arange(v.numel(), dtype=np.float32) % 251).reshape(v.shape)
              for k, v in shapes.items()}
    variables = to_jax_variables(sd, pcfg)
    if backbone == "swin_tiny":
        want = flatten_tree(convert_state_dict(sd, jcfg)["params"])
        got = weights.flatten_tree(variables["params"])
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    back = from_jax_variables(variables, pcfg)
    with torch.device("meta"):
        model = PolyphonicFormer(pcfg)
    result = model.load_state_dict(back, strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)


def test_import_leaves_jax_out():
    """Every module of the port, and ``chip_smoke``, import neither JAX
    (nor flax or optax) nor anything of the JAX package, nor cv2 or PIL:
    the machine with the card has none of them."""
    new = ["tools.convert_torch_ckpt", "data.label_shift", "models.aspp", "models.stdc",
           "models.aligned_fpn", "ops.grid_sample", "ops.deform_conv", "tools.export",
           "tools.flops", "tools.parity_check", "utils.profiling", "ops.device_tables"]
    code = ("import importlib, pkgutil, sys, polyphonicformer_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            f"missing = [m for m in {new!r} if 'polyphonicformer_torch.' + m not in mods]; "
            "[importlib.import_module(m) for m in mods]; import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'polyphonicformer_tpu', 'cv2', 'PIL')]; "
            "print(len(mods), bad, missing); "
            "sys.exit(1 if bad or missing or len(mods) < 80 else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
