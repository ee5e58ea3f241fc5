"""The roofline formulas (``benchmark/roofline``) at the shapes of
``chip_smoke.py`` phase 3, against the bytes its bounds were set from
(PERF.md's kernel table): K1 bf16 (1, 111) 24.2 MB, K2 x2 (111, 128, 256)
72.7 MB, K6 over the three stages (3, 111, 256, 512) 352 MB and K8 at
Swin-L stage 0 232 MB, K9 at B 4, D 64, T 128, BD 64, E 256 1.91 MB.  K6's
formula also counts the logsumexp the op writes (1.6 MB), which phase 3 left
out: within 1%.  The files' ``DEVICE_NAMES`` make the trace's ``port`` class.

The per-configuration FLOPs: the reference's forward at 1024x2048 counts
841.51 GFLOP for R50 and 3,493.25 GFLOP for Swin-L, as
``polyphonicformer_torch/tools/flops.py`` does (PR 13).  Both count the
same convolutions, products and attention's two products of one module
structure with ``FlopCounterMode``; the benchmark's count runs on its own
frozen reference, so a later change to the program leaves it where it is.
"""
import json
from pathlib import Path

import pytest

from benchmark import roofline, trace
from benchmark.reference import config as ref_config
from benchmark.roofline import model_flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _mb(op, shapes, dtypes, scalars):
    return roofline.formula(op).cost(shapes, dtypes, scalars)[0] / 1e6


@pytest.mark.parametrize("op, shapes, dtypes, scalars, mb, rel", [
    ("poly::mask_pool", [[1, 111, 128, 256], [1, 128, 256, 256], []],
     ["c10::BFloat16", "c10::BFloat16", "Scalar"], [None, None, 0.5], 24.2, 0.005),
    ("poly::upsample_int", [[111, 128, 256], [], []], ["float", "Scalar", "Scalar"],
     [None, 2, 2], 72.7, 0.005),
    ("poly::mask_loss_stats", [[3, 111, 256, 512], [3, 111, 256, 512], [3, 111],
                               [3, 256, 512], [3, 256, 512]],
     ["float", "float", "float", "float", "int"], [None] * 5, 352.0, 0.01),
    ("poly::window_attention", [[1, 259, 518, 576], [6, 49, 49], [2738, 49, 49], [], []],
     ["c10::BFloat16", "float", "float", "Scalar", "Scalar"], [None, None, None, 6, 7],
     232.0, 0.005),
    ("poly::tracker_step",
     [[4, 128], [4, 128, 256], [4, 128, 5], [4, 128], [4, 128], [4, 128, 5], [4, 128], [4],
      [4, 64, 256], [4, 64, 5], [4, 64], [4, 64], [4, 64, 5], [4, 64], [4, 64, 256], [4, 64],
      [4], [], [], [], []],
     ["int", "float", "float", "int", "int", "float", "int", "int", "float", "float", "int",
      "bool", "float", "int", "float", "bool", "int", "Scalar", "Scalar", "Scalar", "Scalar"],
     [None] * 17 + [[0.8, 0.5, 0.5, 0.8, 0.5, 0.3, 0.7], 10, True, "bisoftmax"], 1.91, 0.005),
])
def test_bytes_at_phase3_shapes(op, shapes, dtypes, scalars, mb, rel):
    assert _mb(op, shapes, dtypes, scalars) == pytest.approx(mb, rel=rel)


def test_every_poly_op_has_a_formula():
    ops = ("mask_pool", "upsample_int", "upsample_int_bwd", "phase_fusion", "render_maps",
           "solve_lsa", "mask_loss_stats", "mask_loss_grad", "window_attn_math",
           "window_attention", "tracker_step")
    for op in ops:
        assert roofline.formula(f"poly::{op}") is not None, op
    assert roofline.formula("poly::not_an_op") is None


def test_device_names_are_the_port_class():
    # the fragments the trace's port class held as a literal tuple, and K9's
    before = {"mask_pool", "upsample_int", "phase_fusion", "map_render", "lsa_kernel",
              "mask_loss", "window_attn"}
    assert roofline.device_names() == before | {"tracker_step"}
    assert set(trace.KERNEL_CLASSES[0][1]) == before | {"tracker_step"}
    for name in ("void tracker_step_kernel<4>(Params)", "upsample_int_bwd_band",
                 "window_attn_mma_kernel<64, 49>", "mask_pool_sum_splits"):
        assert trace.kernel_class(name) == "port", name
    assert trace.kernel_class("sm90_xmma_gemm_bf16") == "matmul"


def test_least_time_is_the_larger_bound():
    # K8 stage 0: 232 MB at 3.35 TB/s = 69.4 us; 5.05 GFLOP bf16 = 5.1 us
    t = roofline.least_seconds("poly::window_attention",
                               [[1, 259, 518, 576], [6, 49, 49], [2738, 49, 49], [], []],
                               ["c10::BFloat16", "float", "float", "Scalar", "Scalar"],
                               [None, None, None, 6, 7])
    assert t == pytest.approx(69.38e-6, rel=0.01)


@pytest.mark.parametrize("name, gflop", [("video_r50_1x", 841.51), ("video_swinl", 3493.25)])
def test_forward_flops_match_the_ports_count(name, gflop):
    exp = ref_config.load(CONFIGS / f"{name}.json")
    assert model_flops.forward_flops(exp, 1, (1024, 2048)) / 1e9 == pytest.approx(gflop,
                                                                                 abs=0.01)


def test_step_flops_count_backward_and_ref_frames():
    path = str(CONFIGS / "video_r50_1x.json")
    serve = model_flops.step_flops(path, "serve", 1)
    train = model_flops.step_flops(path, "train", 2)
    assert serve > 841.51e9  # the track head on top of the network
    assert 6.0e12 < train < 6.1e12  # 2 x (fwd + bwd) key frames + 2 ref backbones + FPN
