"""FLOPs and bytes of the network forward; the port of
``polyphonicformer_tpu/tools/flops.py``, with the same flags plus
``--device``.

    python -m polyphonicformer_torch.tools.flops --preset video_r50_1x \\
        [--height 1024 --width 2048 --batch 1] [--device cpu]

The JAX tool reads XLA's cost analysis of the compiled program.  Here the
forward runs once, eagerly, on the device under
``torch.utils.flop_counter.FlopCounterMode``: the products (matmuls,
convolutions, attention) of every dispatched op, with formulas registered
for the port's kernels that compute products: ``poly::mask_pool``
(2·B·N·hw·C), the window attention ops ``poly::window_attn_math`` and
``poly::window_attention`` (the two products, 4·windows·heads·L²·hd) and
ViTDet's ``poly::relpos_attention`` (the same, plus the rel terms,
2·windows·heads·L·(kh + kw)·hd).
Elementwise work and reductions are not counted, where XLA counts them, so
the count lies below XLA's (``tests/test_torch_flops.py`` states the band).
``bytes_accessed_GB`` is the sum of each dispatched op's input and output
bytes (view ops left out): what eager execution moves, op by op, not XLA's
count after fusion.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula

from ..ops.cuda import mask_pool, relpos_attn, window_attn  # noqa: F401  (defines the poly:: ops)


def mask_pool_flop(mask_logits_shape, feats_shape, thr, out_shape=None, **kwargs) -> int:
    """2·B·N·hw·C: the (N, hw) x (hw, C) product of each image."""
    b, n, h, w = mask_logits_shape
    return 2 * b * n * h * w * feats_shape[-1]


def window_attn_math_flop(qkv_shape, bias_shape, mask_shape, num_heads, out_shape=None,
                          **kwargs) -> int:
    """Q K^T and P V of each window and head: 4·nw·heads·L²·hd."""
    nw, l, c3 = qkv_shape
    return 4 * nw * l * l * (c3 // 3)


def window_attention_flop(qkv_shape, bias_shape, mask_shape, num_heads, ws, out_shape=None,
                          **kwargs) -> int:
    """The same over the (B, Hp, Wp, 3C) image's windows of ws x ws."""
    b, hp, wp, c3 = qkv_shape
    return 4 * (b * hp * wp // (ws * ws)) * (ws * ws) ** 2 * (c3 // 3)


def relpos_attention_flop(qkv_shape, rel_pos_h_shape, rel_pos_w_shape, num_heads, ws,
                          out_shape=None, **kwargs) -> int:
    """Q K^T and P V of each window (or image) and head, 4·nw·heads·L²·hd,
    and the rel terms q·R_h and q·R_w, 2·nw·heads·L·(kh + kw)·hd."""
    b, hp, wp, c3 = qkv_shape
    kh, kw = (ws, ws) if ws else (hp, wp)
    nw = b * hp * wp // (kh * kw)
    l, c = kh * kw, c3 // 3
    return 4 * nw * l * l * c + 2 * nw * l * (kh + kw) * c


KERNEL_FLOPS = {torch.ops.poly.mask_pool: mask_pool_flop,
                torch.ops.poly.window_attn_math: window_attn_math_flop,
                torch.ops.poly.window_attention: window_attention_flop,
                torch.ops.poly.relpos_attention: relpos_attention_flop}
for _op, _formula in KERNEL_FLOPS.items():
    if _op not in flop_registry:
        register_flop_formula(_op)(_formula)


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every dispatched
    op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out)) if torch.is_tensor(t))
        return out


def count(model, images: torch.Tensor) -> dict:
    """params_M, flops_G and bytes_accessed_GB of ``model(images)``, plus
    the FLOPs by op (``flops_by_op``, G)."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    # the counter's module tracker hooks the gradient of any output that
    # requires one; a module that returns a parameter as it is would have
    # no gradient function
    grads = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        with torch.no_grad(), flops, nbytes:
            model(images)
    finally:
        for p, g in zip(model.parameters(), grads):
            p.requires_grad_(g)
    by_op = {str(op): n / 1e9 for op, n in flops.get_flop_counts()["Global"].items()}
    return {"params_M": sum(p.numel() for p in model.parameters()) / 1e6,
            "flops_G": flops.get_total_flops() / 1e9,
            "bytes_accessed_GB": nbytes.bytes / 1e9, "flops_by_op": by_op}


def analyze(preset: str = None, hw=(1024, 2048), batch: int = 1, device="cuda") -> dict:
    """The JAX tool's ``analyze``: the preset's model (default: the full R50
    one), f32, seeded weights, on ``device``, over a zero image batch."""
    from ..models import build_model
    from ._cli import experiment, select_device

    dev = select_device(str(device))
    cfg = experiment(preset).model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(cfg, dev, generator=gen)
    return count(model, torch.zeros((batch, *hw, 3), device=dev))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    out = analyze(args.preset, (args.height, args.width), args.batch, args.device)
    for k, v in out.items():
        if isinstance(v, float):
            print(f"{k}: {v:.2f}")
    return out


if __name__ == "__main__":
    main()
