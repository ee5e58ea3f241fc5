"""The weight bridge between the JAX package's variables and the port's
state_dict, and the port's independence from JAX and the JAX package."""
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
from polyphonicformer_tpu.tools.convert_torch_ckpt import (
    build_param_mapping,
    convert_state_dict,
    flatten_tree,
)
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import PolyphonicFormer, build_model
from polyphonicformer_torch.weights import from_jax_variables, to_numpy_state_dict

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


@pytest.mark.parametrize("preset", ["video_r50_1x", "debug_tiny_video"])
def test_state_dict_keys_are_reference_keys(preset):
    """590 keys for R50 + 3 stages + track head, exactly the mapping's."""
    cfg = get_preset(preset).model
    with torch.device("meta"):
        model = PolyphonicFormer(model_preset(preset))
    mapping = build_param_mapping(cfg.num_stages, cfg.backbone, cfg.with_track)
    assert set(model.state_dict()) == {key for key, _ in mapping.values()}
    if preset == "video_r50_1x":
        assert len(model.state_dict()) == 590


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


def test_import_leaves_jax_out():
    """The serving path imports neither JAX nor the JAX package (the machine
    with the card has no JAX); the weight bridge takes only the JAX-free key
    mapping of ``tools/convert_torch_ckpt.py``."""
    code = ("import sys, polyphonicformer_torch.infer.pipeline, polyphonicformer_torch.configs; "
            "bad = [m for m in sys.modules if m.startswith(('jax', 'flax', 'polyphonicformer_tpu'))]; "
            "import polyphonicformer_torch.weights; "
            "bad += [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
