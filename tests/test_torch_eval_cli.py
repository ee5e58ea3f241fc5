"""The port's evaluation CLIs (``polyphonicformer_torch/tools/eval_video.py``,
``eval_image.py``, ``demo.py``) end to end on the CPU, against the JAX
package's on the same split and weights.

The split is ``data/synthetic_split.py``'s (2 sequences of 3 frames,
64x128: at this size the seeded ``debug_tiny_video`` weights keep and track
a thing in most frames).  One set of weights, drawn for the port from a
seeded ``torch.Generator`` (the last stage's ``fc_cls`` bias 0, as in
``tests/test_torch_slice.py``), bridged to JAX variables and pickled as
numpy: the JAX CLIs' checkpoint format, which both CLIs read.

- The port's ``eval_video`` in clip mode (``--clip-len 6``: each 3-frame
  sequence padded to 6) and streaming mode (``--clip-len 1``) write
  bit-equal dumps.
- The JAX CLI (``--clip-len 1``) writes GT dumps bit-equal to the port's,
  pred panoptic maps equal on >= 99.9% of each frame's pixels, and depth
  equal where the maps agree within the slice test's f32 bound (rtol 1e-4 +
  atol 2e-3) plus one step of the 1/256 m dump grid; the port's DVPQ and
  STQ over the JAX CLI's dumps equal its ``dvpq.json`` bit for bit (the
  JAX side on its native library, as ``tests/test_torch_evalutils.py``
  explains).
- ``eval_image`` matches JAX's ``evaluate_frames``: depth metrics within
  rtol 1e-5 (measured: 3e-7), PQ within 1e-9 (measured: equal; with random
  weights no segment matches the GT, so PQ is 0 on both sides, and
  ``tests/test_torch_evalutils.py`` holds the PQ arithmetic at nonzero
  values).
- ``demo`` runs on an odd-size image; a checkpoint that holds a JAX array
  raises; a CLI not given ``--device cpu`` raises on a machine without a
  card.
"""
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphonicformer_tpu.configs import get_preset as jax_get_preset
from polyphonicformer_tpu.data.cityscapes_dvps import CityscapesDVPSDataset as JaxDataset
from polyphonicformer_tpu.evalutils.dvpq import list_frames, load_depth_dump
from polyphonicformer_tpu.evalutils.runner import evaluate_frames as jax_evaluate_frames
from polyphonicformer_tpu.ops import native as jax_native
from polyphonicformer_tpu.tools import eval_video as jax_eval_video
from polyphonicformer_torch.configs import apply_overrides, get_preset, model_preset, \
    parse_overrides
from polyphonicformer_torch.data.png import read_png, write_png
from polyphonicformer_torch.data.synthetic_split import write_dvps_split
from polyphonicformer_torch.evalutils import dvpq
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools import demo, eval_image, eval_video
from polyphonicformer_torch.tools.demo import MAGMA_RGB
from polyphonicformer_torch.weights import load_variables, to_jax_variables, \
    to_numpy_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("split"))
    write_dvps_split(root, "val", num_seqs=2, frames_per_seq=3, h=H, w=W)
    cfg = model_preset("debug_tiny_video")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    variables = to_jax_variables(to_numpy_state_dict(model), cfg)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "vars.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump(variables, f)
    jax_so = str(tmp_path_factory.mktemp("jax_native") / "libpolynative.so")
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o",
                    jax_so, "native/lsap.cpp", "native/vpq_core.cpp"], cwd=REPO, check=True)
    return dict(root=root, ckpt=ckpt, variables=variables, jax_so=jax_so,
                tmp=tmp_path_factory.mktemp("runs"))


def _args(s, eval_dir, *extra):
    return ["--data-root", s["root"], "--checkpoint", s["ckpt"], "--preset", "debug_tiny_video",
            "--eval-dir", str(eval_dir), "--nproc", "2", *extra]


@pytest.fixture(scope="module")
def port_runs(setup):
    clip_dir, stream_dir = setup["tmp"] / "clip", setup["tmp"] / "stream"
    out = eval_video.main(_args(setup, clip_dir, "--workers", "2", "--eval-stq",
                                "--device", "cpu"))
    eval_video.main(_args(setup, stream_dir, "--workers", "1", "--clip-len", "1",
                          "--skip-aggregate", "--device", "cpu"))
    return str(clip_dir), str(stream_dir), out


@pytest.fixture(scope="module")
def jax_run(setup):
    jdir = setup["tmp"] / "jax"
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB_PATH", setup["jax_so"])
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(sys, "argv", ["eval_video", *_args(setup, jdir, "--workers", "2",
                                                   "--clip-len", "1", "--eval-stq")])
    try:
        jax_eval_video.main()
    finally:
        mp.undo()
    return str(jdir)


def _names(eval_dir, kind):
    return [os.path.basename(p) for p in list_frames(eval_dir, kind)]


def test_clip_and_streaming_dumps_bit_equal(port_runs):
    clip_dir, stream_dir, out = port_runs
    for kind in ("pred", "gt"):
        assert _names(clip_dir, kind) == _names(stream_dir, kind) and \
            len(_names(clip_dir, kind)) == 6
        for name in _names(clip_dir, kind):
            a = np.load(os.path.join(clip_dir, kind, name))
            b = np.load(os.path.join(stream_dir, kind, name))
            for key in ("panseg", "depth"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{kind} {name} {key}")
    with open(os.path.join(clip_dir, "dvpq.json")) as f:
        results = json.load(f)
    assert results == json.loads(json.dumps(out["results"]))
    # windows k = 1..3 (a sequence has 3 frames) x 4 thresholds, average, STQ
    assert len(results) == 3 * 4 + 2 and "stq" in results
    assert all(np.isfinite(v["pq"]) for k, v in results.items() if k != "stq")
    assert out["inference"]["frames"] == 6
    tracked = sum(int((np.load(p)["panseg"] % 10000 > 0).any())
                  for p in list_frames(clip_dir, "pred"))
    assert tracked >= 3, "a thing must be kept and tracked in most frames"


def test_eval_video_matches_jax_cli(port_runs, jax_run, setup):
    clip_dir, _, _ = port_runs
    for name in _names(jax_run, "gt"):
        a = np.load(os.path.join(clip_dir, "gt", name))
        b = np.load(os.path.join(jax_run, "gt", name))
        for key in ("panseg", "depth"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"gt {name} {key}")
    assert _names(jax_run, "pred") == _names(clip_dir, "pred")
    for name in _names(jax_run, "pred"):
        a = np.load(os.path.join(clip_dir, "pred", name))
        b = np.load(os.path.join(jax_run, "pred", name))
        same = a["panseg"] == b["panseg"]
        assert same.mean() >= 0.999, name
        da, db = load_depth_dump(a)[same], load_depth_dump(b)[same]
        assert (np.abs(da - db) <= 2e-3 + 1e-4 * np.abs(db) + 1 / 256).all(), name

    with open(os.path.join(jax_run, "dvpq.json")) as f:
        want = json.load(f)
    got = eval_video.main(["--data-root", setup["root"], "--checkpoint", setup["ckpt"],
                           "--eval-dir", jax_run, "--nproc", "2", "--skip-infer",
                           "--eval-stq"])["results"]
    assert json.loads(json.dumps(got)) == want
    assert got["stq"]["AQ"] > 0


def test_eval_image_matches_jax(setup, tmp_path):
    out = str(tmp_path / "metrics.json")
    got = eval_image.main(["--data-root", setup["root"], "--checkpoint", setup["ckpt"],
                           "--preset", "debug_tiny_video", "--device", "cpu", "--out", out])
    exp = jax_get_preset("debug_tiny_video")
    ds = JaxDataset(setup["root"], split="val", ref_sample_mode="img")
    want = jax_evaluate_frames(exp.model, exp.data,
                               jax.tree_util.tree_map(jnp.asarray, setup["variables"]), ds,
                               ds.images)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key.startswith("depth_"):
            assert got[key] == pytest.approx(val, rel=1e-5, abs=0), key
        else:
            assert abs(got[key] - val) <= 1e-9, key
    with open(out) as f:
        assert json.load(f) == pytest.approx(got)


def test_demo_on_odd_size(setup, tmp_path):
    """A 50x100 image: padded to 64x128, whose stride-4 logits do not divide
    50x100, so fusion takes the general branch."""
    img = np.random.RandomState(0).randint(0, 256, (50, 100, 3)).astype(np.uint8)
    path = str(tmp_path / "odd.png")
    write_png(path, img)
    written = demo.main([path, "--checkpoint", setup["ckpt"], "--preset", "debug_tiny_video",
                         "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["odd_panoptic.png", "odd_depth.png"]
    pan, depth = (read_png(p) for p in written)
    assert pan.shape == depth.shape == (50, 100, 3) and pan.dtype == np.uint8
    colours = {tuple(c) for c in MAGMA_RGB}
    assert {tuple(c) for c in depth.reshape(-1, 3)} <= colours


@pytest.mark.parametrize("cli", ["eval_video", "eval_image", "demo"])
def test_cli_without_card_raises(setup, tmp_path, cli):
    """Without a CUDA card, a CLI not told --device cpu raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = {"eval_video": _args(setup, tmp_path / "ev", "--skip-aggregate"),
            "eval_image": ["--data-root", setup["root"], "--checkpoint", setup["ckpt"]],
            "demo": [str(tmp_path / "none.png"), "--checkpoint", setup["ckpt"]]}[cli]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        {"eval_video": eval_video, "eval_image": eval_image, "demo": demo}[cli].main(args)


def test_checkpoint_of_jax_arrays_raises(tmp_path):
    path = tmp_path / "jax.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": {"w": jnp.ones(3)}}, f)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        load_variables(path)
    with open(path, "wb") as f:
        pickle.dump({"params": {"f": os.getcwd}}, f)
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        load_variables(path)
    with open(path, "wb") as f:
        pickle.dump({"params": {"w": np.arange(3, dtype=np.float32), "n": np.int64(2)}}, f)
    loaded = load_variables(path)
    np.testing.assert_array_equal(loaded["params"]["w"], np.arange(3, dtype=np.float32))


def test_overrides_match_jax():
    from polyphonicformer_tpu.configs import apply_overrides as jax_apply
    from polyphonicformer_tpu.tools.train import parse_overrides as jax_parse

    pairs = ["model.max_per_img=50", "data.img_size=(512,1024)", "model.with_track=false",
             "model.tracker.match_score_thr=0.4", "schedule.lr_decay_epochs=[3,5]"]
    assert parse_overrides(pairs) == jax_parse(pairs)
    got = apply_overrides(get_preset("video_r50_1x"), parse_overrides(pairs))
    want = jax_apply(jax_get_preset("video_r50_1x"), jax_parse(pairs))
    for path in ("model.max_per_img", "data.img_size", "model.with_track",
                 "model.tracker.match_score_thr", "schedule.lr_decay_epochs"):
        a, b = got, want
        for p in path.split("."):
            a, b = getattr(a, p), getattr(b, p)
        assert a == b and type(a) is type(b), path
