"""The port's checkpoint converter (``polyphonicformer_torch/tools/
convert_torch_ckpt.py``) against the JAX package's
(``polyphonicformer_tpu/tools/convert_torch_ckpt.py``), on the CPU.

The state dicts are seeded port models' (``build_model(generator=...)``):
``debug_tiny``, ``debug_tiny_video`` and ``debug_tiny_video`` on
``swin_tiny``.  Tolerance: none.  Both converters give the same tree, the
same shapes and dtypes and the same values bit for bit; ``main`` writes,
from an mmcv-style ``.pth`` (``{'state_dict': ..., 'meta': {...}}`` with a
``datetime`` and an ``OrderedDict``), a ``.pkl`` that
``weights.load_variables`` reads and the model loads strictly with every
value unchanged; a ``.pth`` that pickles any other object is refused
without ``--unsafe-load``; a missing key raises ``KeyError`` and an STDC
backbone ``ValueError``, as in JAX.
"""
import argparse
import collections
import dataclasses
import datetime
import pickle

import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.tools import convert_torch_ckpt as jax_tool
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools import convert_torch_ckpt as port_tool
from polyphonicformer_torch.weights import (flatten_tree, from_jax_variables, load_variables,
                                            to_numpy_state_dict)

CASES = {"debug_tiny": ("debug_tiny", {}), "debug_tiny_video": ("debug_tiny_video", {}),
         "swin_tiny": ("debug_tiny_video", {"backbone": "swin_tiny"})}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, kw = CASES[request.param]
    pcfg = model_preset(name, **kw)
    jcfg = dataclasses.replace(get_preset(name).model, **kw)
    model = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    return pcfg, jcfg, model, to_numpy_state_dict(model)


def _assert_trees_equal(got, want):
    for coll in ("params", "batch_stats"):
        g, w = flatten_tree(got[coll]), flatten_tree(want[coll])
        assert set(g) == set(w), coll
        for path in w:
            assert g[path].shape == w[path].shape and g[path].dtype == w[path].dtype, path
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)


def test_convert_state_dict_equals_jax(case):
    pcfg, jcfg, _, sd = case
    _assert_trees_equal(port_tool.convert_state_dict(sd, pcfg),
                        jax_tool.convert_state_dict(sd, jcfg))


def _save_pth(path, model, **extra):
    meta = {"mmdet_version": "2.14.0", "time": datetime.datetime(2021, 10, 11, 9, 30),
            "config": collections.OrderedDict(lr=1e-4), **extra}
    torch.save({"state_dict": collections.OrderedDict(model.state_dict()), "meta": meta}, path)


def test_main_round_trips_a_pth(case, tmp_path):
    """``.pth`` -> ``main`` -> ``.pkl`` -> ``load_variables`` -> the model,
    strictly, every value unchanged; the ``.pkl`` equals the JAX tool's
    conversion of the same file."""
    pcfg, jcfg, model, sd = case
    pth, pkl = tmp_path / "m.pth", tmp_path / "v.pkl"
    _save_pth(pth, model)
    args = ["--ckpt", str(pth), "--out", str(pkl), "--backbone", pcfg.backbone]
    port_tool.main(args + (["--video"] if pcfg.with_track else []))
    variables = load_variables(pkl)
    _assert_trees_equal(variables, jax_tool.convert_state_dict(
        jax_tool.load_torch_state_dict(str(pth)), jcfg))
    loaded = build_model(pcfg, "cpu", state_dict=from_jax_variables(variables, pcfg))
    for key, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)


def test_foreign_object_needs_unsafe_load(tmp_path):
    model = build_model(model_preset("debug_tiny"), "cpu",
                        generator=torch.Generator().manual_seed(1))
    pth = tmp_path / "foreign.pth"
    _save_pth(pth, model, args=argparse.Namespace(lr=1e-4))
    out = ["--ckpt", str(pth), "--out", str(tmp_path / "v.pkl")]
    with pytest.raises(RuntimeError, match="--unsafe-load"):
        port_tool.main(out)
    with pytest.raises(RuntimeError, match="--unsafe-load"):
        jax_tool.load_torch_state_dict(str(pth))
    port_tool.main(out + ["--unsafe-load"])
    got = flatten_tree(load_variables(tmp_path / "v.pkl")["params"])
    np.testing.assert_array_equal(
        got["neck/fpn_0/kernel"],
        model.neck.fpn_convs[0].conv.weight.detach().numpy().transpose(2, 3, 1, 0))


def test_missing_key_and_stdc_raise_as_in_jax(case):
    pcfg, jcfg, _, sd = case
    partial = {k: v for k, v in sd.items() if k != "neck.fpn_convs.0.conv.bias"}
    for tool, cfg in ((port_tool, pcfg), (jax_tool, jcfg)):
        with pytest.raises(KeyError, match="1 torch keys missing"):
            tool.convert_state_dict(partial, cfg)
    messages = []
    for tool, cfg in ((port_tool, pcfg), (jax_tool, jcfg)):
        with pytest.raises(ValueError) as err:
            tool.convert_state_dict(sd, dataclasses.replace(cfg, backbone="stdc813"))
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "stdc813" in messages[0]


def test_self_test_passes(capsys):
    port_tool.main(["--self-test"])
    out = capsys.readouterr().out
    assert "self-test OK (resnet50): 590 parameters" in out
    assert "self-test OK (swin_tiny)" in out
