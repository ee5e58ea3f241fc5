"""The port's serving export (``tools/export.py``): ``torch.export``
artifacts of the image and frame modes at ``debug_tiny_video`` widths
(``max_per_img=100``), 64x128 frames, seeded weights with the last
``fc_cls`` bias at 0 (as ``test_torch_slice.py``).

After save and load, an artifact's outputs are bit-equal to the eager step
(as JAX's ``tests/test_export.py`` requires of its artifacts); one artifact
serves the state dicts of two seeds; its graph holds the ``poly::`` kernel
ops; an eager call after the export gives the bits of one before it (the
constant tables are not left holding traced tensors); the artifact loads
without ``torch.export.load``'s ``weights_only=False`` fallback.  The frame
program is held to JAX's exported frame program on the converted
variables at ``test_torch_slice.py``'s f32 tolerances: maps and tracker ids
equal, depth within rtol 1e-4 + atol 2e-3.
"""
import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.infer.tracker import init_tracker_state as jax_init_state
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_tpu.tools import export as jax_export
from polyphonicformer_tpu.tools.convert_torch_ckpt import convert_state_dict
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.infer.tracker import init_tracker_state
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools import export
from polyphonicformer_torch.weights import to_numpy_state_dict

torch.set_num_threads(2)
H, W = 64, 128
# the serving frame's kernels: K1 in the rpn head and twice a stage, the
# three x2 upsamples and the x4 dense depth, K3 on the bf16 fusion, K4
FRAME_OPS = {"mask_pool": 7, "upsample_int": 4, "render_maps": 1}


def _port(seed: int, backbone: str = "resnet50"):
    cfg = model_preset("debug_tiny_video", max_per_img=100, backbone=backbone)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    return cfg, model


@pytest.fixture(scope="module")
def port():
    return _port(0)


def frames(n=2):
    rng = np.random.RandomState(0)
    base = np.repeat(np.repeat(rng.randn(1, H // 16, W // 16, 3) * 2, 16, 1), 16, 2)
    return [(base + 0.1 * rng.randn(1, H, W, 3)).astype(np.float32) for _ in range(n)]


def leaves(tree):
    from torch.utils._pytree import tree_leaves

    return tree_leaves(tree)


def assert_bit_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert x == y


def test_frame_roundtrip_bit_equal(port, caplog):
    """bf16 (K3 in the graph), 2 frames carrying the tracker state."""
    cfg, model = port
    bf16 = torch.bfloat16
    eager = pipeline.make_video_step(model, cfg, (H, W), compute_dtype=bf16, fusion_dtype=bf16)
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, "cpu")
    imgs = [torch.from_numpy(f) for f in frames()]

    def run(step):
        outs, state = [], state0
        for t, img in enumerate(imgs):
            out, state = step(img, state, torch.tensor(t + 1, dtype=torch.int32))
            outs.append((out, state))
        return outs

    before = run(eager)
    blob = export.export_serving(model, cfg, "frame", (H, W), bf16=True)
    assert_bit_equal(run(eager), before)  # eager after the export
    with caplog.at_level(logging.WARNING):
        fn = export.load_serving(blob)
    assert not [r for r in caplog.records if "weights_only" in r.getMessage()]
    assert export.poly_ops(fn.program) == {**FRAME_OPS, "phase_fusion": 1, "tracker_step": 1}
    sd = model.state_dict()
    assert_bit_equal(run(lambda *a: fn(sd, *a)), before)
    assert int(before[-1][1].num_tracklets) > 0, "no detection reached the tracker"
    assert len(blob) < sum(v.numel() * v.element_size() for v in sd.values())


def _fresh_process_ops(cfg, model, tmp_path) -> str:
    """The ``poly::`` ops of the frame artifact of ``model`` as a process
    that imports nothing but ``load_serving`` lists them."""
    path = tmp_path / "frame.pt2"
    path.write_bytes(export.export_serving(model, cfg, "frame", (H, W)))
    code = ("import sys; from polyphonicformer_torch.tools import export; "
            "print(sorted(export.poly_ops(export.load_serving(sys.argv[1]).program)))")
    proc = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()[-1]


def test_frame_artifact_loads_in_a_fresh_process(port, tmp_path):
    """``load_serving`` alone defines every ``poly::`` op the frame program
    calls (the tracker's among them): a process that imports nothing else
    loads the artifact."""
    assert "tracker_step" in _fresh_process_ops(*port, tmp_path)


def test_vit_frame_artifact_loads_in_a_fresh_process(tmp_path):
    """The same on the tiny ViTDet backbone, whose graph holds K10."""
    ops = _fresh_process_ops(*_port(0, "vitdet_tiny"), tmp_path)
    assert "'relpos_attention'" in ops and "'tracker_step'" in ops, ops

def test_image_roundtrip_two_checkpoints(port, tmp_path):
    """f32 image mode: the artifact written to a file and loaded from it
    equals the eager step of each of two seeds' models, given each one's
    state dict."""
    cfg, model = port
    path = tmp_path / "image.pt2"
    path.write_bytes(export.export_serving(model, cfg, "image", (H, W)))
    fn = export.load_serving(str(path))
    assert export.poly_ops(fn.program) == FRAME_OPS
    img = torch.from_numpy(frames(1)[0])
    outs = []
    for m in (model, _port(1)[1]):
        want = pipeline.make_image_step(m, cfg, (H, W))(img)
        got = fn(m.state_dict(), img)
        assert_bit_equal(got, want)
        outs.append(got)
    assert not torch.equal(outs[0].depth, outs[1].depth)


def test_frame_export_matches_jax_export(port):
    """f32 frame programs, each side's export loaded back, 2 frames."""
    cfg, model = port
    jcfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    variables = convert_state_dict(to_numpy_state_dict(model), jcfg)
    jfn = jax_export.load_serving(
        jax_export.export_serving(JaxModel(jcfg), jcfg, variables, "frame", (H, W)))
    pfn = export.load_serving(export.export_serving(model, cfg, "frame", (H, W)))
    js = jax_init_state(jcfg.tracker, jcfg.track_head.embed_channels)
    ps = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, "cpu")
    sd = model.state_dict()
    for t, img in enumerate(frames()):
        oj, js = jfn(variables, jnp.asarray(img), js, jnp.int32(t + 1))
        op, ps = pfn(sd, torch.from_numpy(img), ps, torch.tensor(t + 1, dtype=torch.int32))
        for field in ("semantic", "panoptic", "track_map"):
            np.testing.assert_array_equal(np.asarray(getattr(oj, field)),
                                          getattr(op, field).numpy(), err_msg=field)
        a, b = np.asarray(oj.depth), op.depth.numpy()
        assert (np.abs(a - b) <= 2e-3 + 1e-4 * np.abs(a)).all(), np.abs(a - b).max()
        np.testing.assert_array_equal(np.asarray(js.ids), ps.ids.numpy())
        assert int(js.num_tracklets) == int(ps.num_tracklets) > 0
        assert int(oj.track_overflow) == int(op.track_overflow)


def test_device_tables_kept_only_outside_tracing():
    """An eager call returns the kept table; under a fake tensor mode the
    table is built at the call and nothing is kept."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from polyphonicformer_torch.models import swin
    from polyphonicformer_torch.ops import resize, roi_align

    tables = [(resize._matrix, (5, 10, torch.device("cpu"))),
              (roi_align._device_const, ((1, 2, 3), torch.device("cpu"))),
              (roi_align._support_tables, (5, 10, torch.device("cpu"))),
              (swin._index_on, (3, torch.device("cpu"))),
              (swin._mask_on, (6, 9, 3, 1, torch.device("cpu")))]
    for fn, args in tables:
        fn.cache_clear()
        with FakeTensorMode():
            traced = fn(*args)
        assert all(isinstance(t, FakeTensor) for t in leaves(traced))
        eager = fn(*args)
        assert all(not isinstance(t, FakeTensor) for t in leaves(eager))
        assert all(a is b for a, b in zip(leaves(fn(*args)), leaves(eager)))
