"""The port's FLOPs tool (``tools/flops.py``) against the JAX package's
(XLA's cost analysis of the compiled forward), on the CPU.

``params_M`` is equal.  ``flops_G`` lies in a band above XLA's: the port
counts every multiply-add of each convolution, XLA only those that touch
the input and not its zero padding (``HloCostAnalysis`` counts the valid
window positions), which at the small maps of a 64x128 image is a large
share of a 3x3 convolution's taps.  The share falls as the image grows:
``debug_tiny`` measured 1.0758 x XLA's at 64x128, 1.0325 at 128x256,
1.0103 at 256x512 when this test was written.  XLA also counts elementwise
operations, which the port does not; at these sizes they are small.  The
kernels' formulas are counted: without them the count drops by their
analytic amount, K1 on ``debug_tiny``, K7 and K8 on a ``swin_tiny``
backbone, K10 on a ``vitdet_tiny`` one.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from polyphonicformer_tpu.tools import flops as jax_flops
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools import flops

torch.set_num_threads(2)


def test_params_equal_jax():
    got = flops.analyze("debug_tiny_video", (64, 128), 1, "cpu")
    want = jax_flops.analyze("debug_tiny_video", (64, 128), 1)
    assert got["params_M"] == want["params_M"]
    assert got["flops_G"] > 0 and got["bytes_accessed_GB"] > 0


@pytest.mark.parametrize("hw,band", [((64, 128), (1.0, 1.10)), ((128, 256), (1.0, 1.05))])
def test_flops_band_against_xla(hw, band):
    got = flops.analyze("debug_tiny", hw, 1, "cpu")["flops_G"]
    want = jax_flops.analyze("debug_tiny", hw, 1)["flops_G"]
    assert band[0] <= got / want <= band[1], got / want


class _Shapes(TorchDispatchMode):
    """Records the arguments of every ``poly::`` op call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "poly":
            self.calls.append((func.__name__.split(".")[0], args))
        return func(*args, **(kwargs or {}))


def _analytic(calls) -> dict:
    """FLOPs written out from each call's shapes: K1 2·B·N·hw·C; K7/K8
    Q K^T and P V, 2·L·L·hd each per window and head; K10 the same and
    q·R_h, q·R_w, 2·L·kh·hd and 2·L·kw·hd."""
    out = {}
    for name, args in calls:
        if name == "mask_pool":
            (b, n, h, w), c = args[0].shape, args[1].shape[-1]
            n_flops = 2 * b * n * h * w * c
        elif name == "window_attn_math":
            nw, l, c3 = args[0].shape
            n_flops = nw * args[3] * 2 * (2 * l * l * (c3 // 3 // args[3]))
        elif name == "window_attention":
            b, hp, wp, c3 = args[0].shape
            ws = args[4]
            n_flops = (b * hp * wp // ws ** 2) * args[3] * 2 * (2 * ws ** 4 * (c3 // 3 // args[3]))
        elif name == "relpos_attention":
            b, hp, wp, c3 = args[0].shape
            kh, kw = (args[4], args[4]) if args[4] else (hp, wp)
            hd = c3 // 3 // args[3]
            n_flops = (b * hp * wp // (kh * kw)) * args[3] * (
                2 * (2 * (kh * kw) ** 2 * hd) + 2 * kh * kw * (kh + kw) * hd)
        else:
            continue
        out[name] = out.get(name, 0) + n_flops
    return out


@pytest.mark.parametrize("backbone,ops", [
    ("resnet50", ("mask_pool",)),
    ("swin_tiny", ("mask_pool", "window_attn_math", "window_attention")),
    ("vitdet_tiny", ("mask_pool", "relpos_attention"))])
def test_kernel_formulas_counted(backbone, ops, monkeypatch):
    cfg = dataclasses.replace(model_preset("debug_tiny"), backbone=backbone)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    images = torch.zeros((1, 64, 128, 3))
    spy = _Shapes()
    with torch.no_grad(), spy:
        model(images)
    analytic = _analytic(spy.calls)
    assert set(analytic) == set(ops)
    full = flops.count(model, images)
    for name in ops:
        assert full["flops_by_op"][f"poly.{name}"] * 1e9 == pytest.approx(analytic[name], rel=1e-12)
    for name in ops:
        monkeypatch.delitem(flop_registry, getattr(torch.ops.poly, name))
    bare = flops.count(model, images)
    assert (full["flops_G"] - bare["flops_G"]) * 1e9 == pytest.approx(sum(analytic.values()),
                                                                      rel=1e-9)
