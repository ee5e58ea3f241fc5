"""The port's serving export, continued (``tools/export.py``; setting as in
``test_torch_export.py``): the clip mode at T=2, loaded in a fresh process
through ``load_serving`` alone (no configuration, no model built, no JAX)
and bit-equal there to the eager clip step; the clip program and the image
program with the bf16 fusion held to JAX's exported programs at
``test_torch_slice.py``'s tolerances (maps equal; depth within rtol 1e-4 +
atol 2e-3 in f32 and within one bf16 ulp, rtol 2^-7, on the bf16 fusion);
the CLI with ``--device cpu``.

The bf16 comparison runs the network in f32 and the fusion in bf16 on both
sides (each side's ``build_serving_fn`` bound so for the test): with the
network in bf16 too, the two packages' CPU convolutions round differently
and 1.7% of the labels differ at these widths, exported or not.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.infer import pipeline as jax_pipeline
from polyphonicformer_tpu.infer.tracker import init_tracker_state as jax_init_state
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools import export as jax_export
from polyphonicformer_tpu.tools.convert_torch_ckpt import convert_state_dict
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.infer.tracker import TrackerState, init_tracker_state
from polyphonicformer_torch.tools import export
from polyphonicformer_torch.weights import to_numpy_state_dict

from test_torch_export import H, W, _port, frames, leaves

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

LOADER = r"""
import sys, torch
torch.set_num_threads(2)
import polyphonicformer_torch.models.polyphonic as P
def built(*a, **k):
    raise AssertionError("a model was built")
P.PolyphonicFormer.__init__ = built
P.build_model = built
from polyphonicformer_torch.infer.tracker import TrackerState
from polyphonicformer_torch.tools.export import load_serving
inp = torch.load(sys.argv[2], weights_only=True)
fn = load_serving(sys.argv[1])
out, state = fn(inp["sd"], inp["images"], TrackerState(**inp["state"]), inp["fid"])
from torch.utils._pytree import tree_leaves
torch.save([x for x in tree_leaves((out, state)) if torch.is_tensor(x)], sys.argv[3])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "polyphonicformer_tpu")]
sys.exit(1 if bad else 0)
"""


@pytest.fixture(scope="module")
def port():
    return _port(0)


@pytest.fixture(scope="module")
def clip_artifact(port):
    cfg, model = port
    return export.export_serving(model, cfg, "clip", (H, W), clip_len=2)


def _jax(model):
    jcfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    return jcfg, JaxModel(jcfg), convert_state_dict(to_numpy_state_dict(model), jcfg)


def test_clip_loaded_in_fresh_process(port, clip_artifact, tmp_path):
    cfg, model = port
    path = tmp_path / "clip.pt2"
    path.write_bytes(clip_artifact)
    images = torch.from_numpy(np.concatenate(frames(2)))
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, "cpu")
    fid = torch.tensor(1, dtype=torch.int32)
    want = pipeline.make_clip_step(model, cfg, (H, W))(images, state0, fid)
    torch.save({"sd": model.state_dict(), "images": images, "fid": fid,
                "state": dataclasses.asdict(state0)}, tmp_path / "inputs.pt")
    proc = subprocess.run([sys.executable, "-c", LOADER, str(path), str(tmp_path / "inputs.pt"),
                           str(tmp_path / "out.pt")], cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    want_t = [x for x in leaves(want) if torch.is_tensor(x)]
    assert len(got) == len(want_t) == 17  # 5 clip maps, 12 tracker fields
    for a, b in zip(got, want_t):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(want[1], TrackerState) and int(want[1].num_tracklets) > 0


def test_clip_export_matches_jax_export(port, clip_artifact):
    """f32 clip programs, T=2, each side's export loaded back."""
    cfg, model = port
    jcfg, jm, variables = _jax(model)
    imgs = np.concatenate(frames(2))
    jfn = jax_export.load_serving(
        jax_export.export_serving(jm, jcfg, variables, "clip", (H, W), clip_len=2))
    pfn = export.load_serving(clip_artifact)
    oj, js = jfn(variables, jnp.asarray(imgs),
                 jax_init_state(jcfg.tracker, jcfg.track_head.embed_channels), jnp.int32(1))
    op, ps = pfn(model.state_dict(), torch.from_numpy(imgs),
                 init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, "cpu"),
                 torch.tensor(1, dtype=torch.int32))
    for field in ("semantic", "panoptic", "track_map", "track_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(oj, field)),
                                      getattr(op, field).numpy(), err_msg=field)
    a, b = np.asarray(oj.depth), op.depth.numpy()
    assert (np.abs(a - b) <= 2e-3 + 1e-4 * np.abs(a)).all(), np.abs(a - b).max()
    np.testing.assert_array_equal(np.asarray(js.ids), ps.ids.numpy())


def test_image_bf16_fusion_matches_jax_export(port, monkeypatch):
    """The image programs with the bf16 fusion (the JAX side's Pallas
    kernels interpreted), network in f32; the port's graph holds K3."""
    cfg, model = port
    jcfg, jm, variables = _jax(model)
    monkeypatch.setenv("POLY_PALLAS_FUSION", "interpret")
    monkeypatch.setattr(jax_export, "build_serving_fn", lambda m, c, mode, hw, bf16=False: (
        jax_pipeline.make_image_step(m, c, tuple(hw), compute_dtype=jnp.float32,
                                     fusion_dtype=jnp.bfloat16)))
    monkeypatch.setattr(export, "build_serving_fn", lambda m, c, mode, hw, bf16=False: (
        export._WeightFree(m, c, mode, hw, torch.float32, torch.bfloat16)))
    img = frames(1)[0]
    pj = jax_export.load_serving(
        jax_export.export_serving(jm, jcfg, variables, "image", (H, W), bf16=True))(
            variables, jnp.asarray(img))
    pfn = export.load_serving(export.export_serving(model, cfg, "image", (H, W), bf16=True))
    assert export.poly_ops(pfn.program)["phase_fusion"] == 1
    pp = pfn(model.state_dict(), torch.from_numpy(img))
    for field in ("semantic", "panoptic", "keep", "seg_ids", "labels"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, field)),
                                      getattr(pp, field).numpy(), err_msg=field)
    a, b = np.asarray(pj.depth), pp.depth.numpy()
    assert (np.abs(a - b) <= 2e-3 + 2.0 ** -7 * np.abs(a)).all(), np.abs(a - b).max()


def test_cli(tmp_path):
    """``main`` with the JAX CLI's flags and ``--device cpu``; the written
    artifact loads and its graph holds the image step's kernels."""
    out = tmp_path / "image.pt2"
    info = export.main(["--mode", "image", "--hw", "64", "128", "--preset", "debug_tiny",
                        "--out", str(out), "--device", "cpu"])
    assert info["bytes"] == out.stat().st_size > 0
    assert info["poly_ops"] == {"mask_pool": 7, "upsample_int": 4, "render_maps": 1}
    assert export.poly_ops(export.load_serving(str(out)).program) == info["poly_ops"]
