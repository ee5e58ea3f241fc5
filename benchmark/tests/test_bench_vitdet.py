"""The ViTDet ViT-L cell, ``vitdetl_serve_4streams``, and what it adds: the
configuration's reference backbone (``reference/models/vit.py``, built by
``reference/backbones/vitdet_large.py``), K10's roofline file and the four
per-layer readers.

The benchmark's reference copy is held to the tests' plain reference
(``tests/vitdet_reference.py``) on one tiny seeded draw, within f32
rounding: the copy computes the attention per block of query rows, the
tests' reference in one product.  The step's FLOPs at 1024x2048, B = 4,
count 28.519 TFLOP: 7,113.32 GFLOP of forward a frame, 2.03 times
Swin-L's 3,493.25.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from benchmark import cells, roofline, spans, trace as T
from benchmark.reference import config as ref_config
from benchmark.reference.models import vit
from benchmark.roofline import model_flops

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELL = "vitdetl_serve_4streams"
NEW = ("kernel_roofline.relpos_global.serve", "kernel_roofline.relpos_window.serve",
       "vit_global_attn_ms.serve", "vit_window_attn_ms.serve")


def _tests_reference():
    spec = importlib.util.spec_from_file_location("vitdet_reference",
                                                  ROOT / "tests" / "vitdet_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cell_resolves_and_reports():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.mix["name"] == "serve_4streams"
    assert cell.config["preset"] == "video_vitdetl"
    assert cell.config["experiment"]["model"]["backbone"] == "vitdet_large"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "frame_p95_ms",
                                                    "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and {"mfu.serve", "kernel_roofline.serve"} <= names
    for name in names:
        assert callable(cells.metric_reader(name))
    assert set(cell.limits) == set(json.loads(
        (HERE / "limits" / "swinl_serve_4streams.json").read_text()))


@pytest.mark.parametrize("chunk", [vit.CHUNK, 40])
def test_reference_copy_matches_the_tests_reference(monkeypatch, chunk):
    """One tiny draw (embed 64, depth 4, global blocks 1 and 3, 2 heads,
    windows of 3 on a 4 x 8 grid), the copy's query blocks whole or of one
    row: the pyramid's four levels agree within f32 rounding."""
    ref = _tests_reference()
    monkeypatch.setattr(vit, "CHUNK", chunk)
    want = ref.Backbone(64, 4, 2, (1, 3), 3, 32)
    gen = torch.Generator().manual_seed(20)
    with torch.no_grad():
        for name, p in want.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() > 1 else 1.0))
    got_vit, got_neck = vit.ViT(64, 4, 2, (1, 3), 3), vit.SimpleFeaturePyramid(64, 32)
    got_vit.load_state_dict(want.backbone.state_dict(), strict=True)
    got_neck.load_state_dict(want.neck.state_dict(), strict=True)
    x = torch.randn(2, 3, 64, 128, generator=gen)
    with torch.no_grad():
        for g, w in zip(got_neck(got_vit(x)), want(x)):
            assert g.shape == w.shape
            assert ((g - w).norm() / w.norm()).item() < 1e-5


def test_large_backbone_keys_and_draw():
    from benchmark.reference.models.polyphonic import backbone_file

    exp = ref_config.load(HERE / "configs" / "video_vitdetl.json")
    mod = backbone_file("vitdet_large")
    with torch.device("meta"):
        backbone, neck = mod.build(exp.model)
    keys = set(backbone.state_dict()) | {f"neck.{k}" for k in neck.state_dict()}
    assert {"blocks.23.attn.rel_pos_w", "pos_embed", "neck.simfp_2.5.norm.weight"} <= keys
    assert backbone.blocks[5].attn.rel_pos_h.shape == (127, 64)
    assert backbone.blocks[4].attn.rel_pos_h.shape == (27, 64)
    assert mod.INIT_STD == {"pos_embed": 0.02, "rel_pos_h": 0.1, "rel_pos_w": 0.1}


def test_step_flops():
    path = str(HERE / "configs" / "video_vitdetl.json")
    assert model_flops.step_flops(path, "serve", 4) / 1e12 == pytest.approx(28.519, abs=1e-3)
    exp = ref_config.load(path)
    assert model_flops.forward_flops(exp, 1, (1024, 2048)) / 1e9 == pytest.approx(7113.32,
                                                                                  abs=0.01)


GLOBAL = ("poly::relpos_attention", [[4, 64, 128, 3072], [127, 64], [255, 64], [], []],
          ["c10::BFloat16"] * 3 + ["Scalar", "Scalar"], [None, None, None, 16, 0])
WINDOW = ("poly::relpos_attention", [[4, 70, 140, 3072], [27, 64], [27, 64], [], []],
          ["c10::BFloat16"] * 3 + ["Scalar", "Scalar"], [None, None, None, 16, 14])


def test_roofline_of_both_modes():
    """Global: 1.0995 TFLOP of products and 12.9 GFLOP of rel terms, bound by
    operations (1.125 ms); window: 321 MB, bound by bytes (96 us)."""
    b, f, dt = roofline.formula("poly::relpos_attention").cost(*GLOBAL[1:])
    assert f == 4 * 4 * 16 * 8192 ** 2 * 64 + 2 * 4 * 16 * 8192 * 192 * 64
    assert roofline.least_seconds(*GLOBAL) == pytest.approx(f / 989e12)
    b, f, dt = roofline.formula("poly::relpos_attention").cost(*WINDOW[1:])
    assert b == pytest.approx(4 * 70 * 140 * 4096 * 2 + 2 * 27 * 64 * 2)
    assert roofline.least_seconds(*WINDOW) == pytest.approx(b / 3.35e12)
    assert "relpos_attn" in roofline.device_names()
    for name in ("(anonymous namespace)::relpos_attn_global_kernel((anonymous namespace)::Args)",
                 "(anonymous namespace)::relpos_attn_window_kernel((anonymous namespace)::Args)"):
        assert T.kernel_class(name) == "port"


def _trace(ops, device, rows=None) -> T.Trace:
    reading = None if rows is None else spans.Reading(rows=rows, groups={}, window_ms=1.0,
                                                      busy_ms=1.0, idle_ms=0.0)
    return T.Trace(kind="serve", steps=2, frames=8, samples=0, span_s=1.0, busy_s=1.0,
                   device=device, ops=ops, port_s=1.0, step_flops=1.0,
                   compute_dtype="bfloat16", spans=reading)


def test_readers_pick_their_calls():
    other = ("poly::window_attention", [[1, 259, 518, 576], [6, 49, 49], [], [], []],
             ["c10::BFloat16", "float", "float", "Scalar", "Scalar"], [None, None, None, 6, 7])
    ops = [GLOBAL, WINDOW, GLOBAL, other, WINDOW]
    device = [("relpos_attn_global_kernel(Args)", 0.0, 4000.0),
              ("relpos_attn_global_kernel(Args)", 5000.0, 9000.0),
              ("relpos_attn_window_kernel(Args)", 9000.0, 9400.0),
              ("relpos_attn_window_kernel(Args)", 9500.0, 9900.0),
              ("window_attn_mma_kernel<64, 49>", 9900.0, 10000.0)]
    tr = _trace(ops, device)
    glob = 2 * roofline.least_seconds(*GLOBAL) / 8000e-6 * 100
    win = 2 * roofline.least_seconds(*WINDOW) / 800e-6 * 100
    assert cells.metric_reader(NEW[0])(tr) == pytest.approx(glob)
    assert cells.metric_reader(NEW[1])(tr) == pytest.approx(win)
    # a program without K10 (the parent): nothing to read, no raise
    bare = _trace([other], device[-1:])
    assert cells.metric_reader(NEW[0])(bare) is None
    assert cells.metric_reader(NEW[1])(bare) is None


def test_span_readers():
    row = dict(calls=8, host_ms=1.0, self_ms=1.0, launches=40, device_ms=24.0, idle_ms=0.5)
    tr = _trace([], [], rows={"model/vit_global_attn": row,
                              "model/vit_window_attn": dict(row, device_ms=12.0)})
    assert cells.metric_reader(NEW[2])(tr) == pytest.approx(24.0 / 8)
    assert cells.metric_reader(NEW[3])(tr) == pytest.approx(12.0 / 8)
    assert cells.metric_reader(NEW[2])(_trace([], [], rows={})) is None
    assert cells.metric_reader(NEW[3])(_trace([], [])) is None
