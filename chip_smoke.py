"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases: (1) the device; (2) the build of the hand-written kernels from
``polyphonicformer_torch/csrc``, and their tensor-core instructions in
``cuobjdump -sass`` (the bf16 K7/K8 and K1 must have some); (3) each
kernel against its plain PyTorch version at the shapes the serving and
training paths give it, timed beside the plain version and, where one
PyTorch call computes the same function,
that call, with the least time the card could take (bytes over 3.35 TB/s or
operations over the peak of their type, whichever is larger), and the
gradients of K7 and K8 at Swin-L stage shapes against the plain versions'
autograd; (4) the R50
video serving path (``video_r50_1x``, seeded random weights) on an 8-frame
1024x2048 clip in bf16 through ``clip_video_step``; (5) the image-model
train step (``image_r50_2x``, seeded random weights) at 1024x2048, batch 1,
f32, through ``create_train_state`` and ``make_train_step`` for 3 steps,
then a debug-size step on the card against the same step on the CPU, and a
debug-size ``swin_tiny`` step whose gradients on the card (through K7 and
K8) are held to the same step in f64 on the CPU and to the card's plain
route; (6)
the Swin-L video serving path (``video_swinl``, seeded random weights, bf16)
on an 8-frame 1024x2048 clip through ``make_clip_step``, then 3 steps of
``make_batched_video_step`` over 2 clips, then a debug-size ``swin_tiny``
forward on the card against the same forward on the CPU; (7) the 2-frame
video train step (``video_r50_1x``, seeded random weights) at 1024x2048,
batch 1, f32, through ``make_train_step(video=True)`` for 3 steps, its GT
track boxes from the exact support marginals against those of the
materialised x4 upsample, a debug-size video step on the card against the
same step on the CPU in f64, then one warm ``video_swinl`` bf16 video step
at 1024x2048 and the full-width time of K7/K8's backward (the plain
versions' VJP); (8) the evaluation CLIs from PNGs on disk: a 1024x2048
Cityscapes-DVPS-layout val split of 2 sequences x 6 frames written with the
port's PNG encoder (Paeth rows) and seeded ``video_r50_1x`` weights pickled
as the JAX CLIs' checkpoint, then ``tools/eval_video.py`` in bf16 in clip
mode (6 frames a clip, 4 decode workers, DVPQ and STQ) and again in
streaming mode under ``torch.profiler`` (device busy time), their dumps
bit-equal and the GT dumps equal to the decoded PNGs, ``tools/eval_image.py``
over the split, and ``tools/demo.py`` on a 1000x2000 image (the general
fusion branch), with the PNG decode, loader, dump-write and aggregation
times.  Phases 4, 5, 6, 7 and 8
each count the kernel launches of their own run.  Any failed phase raises,
so the exit code is not 0.  The last lines are the
card, a JSON object of per-kernel results and the JSON result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense tensor-core bf16, f32 FMAs without (2 operations a lane and clock), and
# one f32-pipe instruction a lane and clock (132 SMs x 128 lanes x 1.98 GHz,
# half the FMA rate): the rate of K3's exact merge, whose separately rounded
# multiplies and adds cannot fuse into FMAs
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "f32_issue": 33.5e12}
# K3's f32-pipe instructions per output pixel and candidate row, counted from
# csrc/phase_fusion.cu: the horizontal lerp with its products shared between
# phases (2.5), the share of the vertical lerps (2.25), the score multiply,
# the argmax's compare and select (a folded row: a compare), the >= 0.5
# compare of a full row
K3_INSTR_FULL, K3_INSTR_FOLDED = 8.75, 6.75


def _bound(nbytes: float, ops: float = 0.0, kind: str = "f32") -> dict:
    """The least time for moving ``nbytes`` and doing ``ops`` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_us": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _tensor_core_ops(so_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel of the built
    library, from ``cuobjdump -sass``; kernels without any are left out."""
    import os
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"\b(HMMA|HGMMA)\b", line):
            short = re.search(r"\d+((?:window_attn|mask_pool)_(?:mma|sum)\w*)", fn)
            key = short.group(1).split("Ev")[0] if short else fn
            counts[key] = counts.get(key, 0) + 1
    return counts


SLEEP_CYCLES = 2_000_000  # ~1 ms of device clock queued ahead of each timed call


def _time_ms(fn, reps: int = 20) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` warm runs (CUDA
    events).  Each run is queued behind a device sleep, so the host issues
    ``fn``'s launches before the card reaches them and the events time the
    card, not the wrapper's host time (a call whose host time exceeds the
    sleep, as some plain versions', still shows it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _check(name: str, ok: bool, detail: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def _exact(name, got, want) -> float:
    import torch

    _check(name, got.shape == want.shape and got.dtype == want.dtype,
           f"shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    bad = int((got != want).sum())
    _check(name, bad == 0, f"{bad} elements differ")
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_kernels(dev, gen) -> list[dict]:
    """Phase 3: every kernel of the serving path against its plain version."""
    import torch

    from torch.nn import functional as F

    from polyphonicformer_torch.ops.cuda import map_render, mask_pool, phase_fusion, upsample2

    rows = []

    def pool_row(name, logits, feats):
        """K1 against its plain version (rtol 1e-5 of sum |feat| over each
        mask), twice for equal bits, then timed.  Library: the cuBLAS
        product of the pre-thresholded mask in the features' dtype (the
        threshold itself is outside the timed call)."""
        got = mask_pool.masked_pool(logits, feats)
        again = mask_pool.masked_pool(logits, feats)
        torch.cuda.synchronize()
        want = mask_pool.mask_pool_plain(logits, feats)
        hard = (torch.sigmoid(logits.float()) > 0.5).float()
        bound = 1e-5 * torch.einsum("bnhw,bhwc->bnc", hard, feats.float().abs()) + 1e-6
        diff = (got - want).abs()
        _check(name, bool((diff <= bound).all()),
               f"max err {float(diff.max())} beyond rtol 1e-5 of sum|feat|")
        _check(name, torch.equal(got, again), "two launches differ")
        hard = hard.to(feats.dtype).flatten(2)
        feats_flat = feats.flatten(1, 2)
        # f32 features: three exact bf16 products on the tensor cores
        ops = 2.0 * logits.numel() * feats.shape[-1] * (3 if feats.dtype == torch.float32 else 1)
        return dict(
            name=name, kernel="mask_pool", route="cuda",
            source="polyphonicformer_torch/csrc/mask_pool.cu",
            replaces="polyphonicformer_tpu/ops/pallas/mask_pool.py:45",
            max_abs_err=float(diff.max()),
            ms=_time_ms(lambda: mask_pool.masked_pool(logits, feats)),
            plain_ms=_time_ms(lambda: mask_pool.mask_pool_plain(logits, feats)),
            library_ms=_time_ms(lambda: torch.matmul(hard, feats_flat)),
            shape=f"logits {tuple(logits.shape)} {logits.dtype}, feats NCHW "
                  f"{tuple(feats.permute(0, 3, 1, 2).shape)} {feats.dtype}",
            **_bound(_nbytes(logits, feats, got), ops, "bf16"))

    # K1 mask_pool: each stage (111 rows) and the rpn head (100 rows); feats
    # are the NCHW module tensors seen as (B, h, w, C) views, bf16 when
    # serving; f32 logits and feats in the f32 train step
    feats = torch.randn((1, 256, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
    feats_hwc = feats.permute(0, 2, 3, 1)
    for n, name in ((111, "mask_pool"), (100, "mask_pool_n100")):
        logits = torch.randn((1, n, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
        rows.append(pool_row(name, logits, feats_hwc))
    logits = torch.randn((1, 111, 128, 256), generator=gen, device=dev)
    feats32 = torch.randn((1, 256, 128, 256), generator=gen, device=dev).permute(0, 2, 3, 1)
    rows.append(pool_row("mask_pool_f32", logits, feats32))
    del feats32

    # K2 upsample, bit-equal: x2 of the serving stage masks, of the stacked
    # training masks, of the depth logits (checked, not timed), x4 of the
    # depth to full resolution
    for shape, f, name in (((111, 128, 256), 2, "upsample2"), ((444, 128, 256), 2, "upsample2_444"),
                           ((1, 128, 256), 2, None), ((1, 256, 512), 4, "upsample2_x4")):
        x = torch.randn(shape, generator=gen, device=dev)
        got = upsample2.upsample_int(x, f)
        torch.cuda.synchronize()
        err = _exact(f"upsample x{f} {shape}", got, upsample2.upsample_int_plain(x, f, f))
        if name is None:
            continue
        rows.append(dict(
            name=name, kernel="upsample2", route="cuda",
            source="polyphonicformer_torch/csrc/upsample.cu",
            replaces="polyphonicformer_tpu/ops/pallas/upsample2.py:154", max_abs_err=err,
            ms=_time_ms(lambda: upsample2.upsample_int(x, f)),
            plain_ms=_time_ms(lambda: upsample2.upsample_int_plain(x, f, f)),
            library_ms=_time_ms(lambda: F.interpolate(x[:, None], scale_factor=f, mode="bilinear",
                                                      align_corners=False)),
            shape=f"{shape} f32 x{f}", **_bound(_nbytes(x, got))))
        del got

    # K3 phase_fusion: 111 bf16 candidates at stride 4 -> 1024x2048, f32
    # scores, pruned to 64 full rows and not
    probs = torch.sigmoid(torch.randn((111, 256, 512), generator=gen, device=dev) * 3)
    probs = probs.to(torch.bfloat16)
    scores = torch.rand((111,), generator=gen, device=dev)
    depth = (torch.rand((111, 256, 512), generator=gen, device=dev) * 70 + 1).to(torch.bfloat16)
    err = 0.0
    for n_full in (64, None):
        got = phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=n_full)
        torch.cuda.synchronize()
        want = phase_fusion.phase_fusion_plain(probs, scores, depth, 4, 4, n_full=n_full)
        tag = f"phase_fusion n_full={n_full}"
        _exact(tag + " pix", got[0], want[0])
        for i, part in ((2, "row_marg"), (3, "col_marg"), (4, "oarea")):
            _exact(f"{tag} {part}", got[i], want[i])
        diff = (got[1] - want[1]).abs()
        _check(tag + " dep", bool((diff <= 1e-4 + 1e-5 * want[1].abs()).all()),
               f"max err {float(diff.max())}")
        err = max(err, float(diff.max()))
    outs = phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=64)
    kpad, nf, _ = phase_fusion._rows(probs.shape[0], 64)
    ops = outs[0].numel() * (nf * K3_INSTR_FULL + (kpad - nf) * K3_INSTR_FOLDED)
    rows.append(dict(
        name="phase_fusion", route="cuda", source="polyphonicformer_torch/csrc/phase_fusion.cu",
        replaces="polyphonicformer_tpu/ops/pallas/phase_fusion.py:126", max_abs_err=err,
        library_ms=None, **_bound(_nbytes(probs, scores, depth, *outs), ops, "f32_issue"),
        ms=_time_ms(lambda: phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=64)),
        plain_ms=_time_ms(lambda: phase_fusion.phase_fusion_plain(
            probs, scores, depth, 4, 4, n_full=64), reps=5)))

    # K4 map_render: 64 table rows, pix in [0, 64] (64 is the sentinel)
    k = 64
    pix = torch.randint(0, k + 1, (1024, 2048), generator=gen, device=dev, dtype=torch.int32)
    dep = torch.rand((1024, 2048), generator=gen, device=dev) * 80
    db = torch.rand((1024, 2048), generator=gen, device=dev) * 80
    labels = torch.randint(0, 19, (k,), generator=gen, device=dev, dtype=torch.int32)
    seg = torch.randint(0, k + 1, (k,), generator=gen, device=dev, dtype=torch.int32)
    keep = torch.rand((k,), generator=gen, device=dev) > 0.4
    trk = torch.randint(0, 1 << 20, (k,), generator=gen, device=dev, dtype=torch.int32) * keep
    args = (pix, dep, db, labels, seg, keep, trk, 19)
    got = map_render.render_maps(*args)
    torch.cuda.synchronize()
    want = map_render.render_maps_plain(*args)
    err = max(_exact(f"map_render {name}", g, w)
              for name, g, w in zip(("semantic", "panoptic", "depth", "track"), got, want))
    rows.append(dict(
        name="map_render", route="cuda", source="polyphonicformer_torch/csrc/map_render.cu",
        replaces="polyphonicformer_tpu/ops/pallas/map_render.py:53", max_abs_err=err,
        library_ms=None,
        **_bound(_nbytes(*(a for a in args if isinstance(a, torch.Tensor)), *got)),
        ms=_time_ms(lambda: map_render.render_maps(*args)),
        plain_ms=_time_ms(lambda: map_render.render_maps_plain(*args))))
    return rows


def check_swin_kernels(dev, gen) -> list[dict]:
    """Phase 3, every Swin-L shape of one 1024x2048 bf16 frame, each with the
    shift mask and without: K8 at stage 0 (259x518 padded, 2,738 windows, 6
    heads, C 192) and stage 1 (133x259, 703 windows, 12 heads, C 384), K7 at
    stage 2 (70x133, 190 windows, 24 heads, C 768) and stage 3 (35x70, 50
    windows, 48 heads, C 1536).  Tolerance: within one bf16 spacing (ulp) of
    the output everywhere, as one flipped output rounding; K7's rounding of
    P to bf16 leaves no more room (without it, outputs move by up to
    hundreds of ulps).  Library: ``F.scaled_dot_product_attention`` with
    ``attn_mask = bias + mask`` on the partitioned (windows, heads, 49, 32)
    tensors (the partition and the mask sum are outside the timed call).
    Each row times the kernel, its plain version and the library call with
    the mask (``ms``, ...) and without (``ms_no_mask``, ...), each beside its
    own bound."""
    import torch
    from torch.nn import functional as F

    from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition
    from polyphonicformer_torch.ops.cuda import window_attn

    ws, l = 7, 49

    def inputs(hp, wp, c, heads):
        qkv = torch.randn((1, hp, wp, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((heads, l, l), generator=gen, device=dev) * 0.5
        mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, 3)).to(dev)
        return qkv, bias, mask

    def checked(name, got, want):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8)  # bf16 spacing at the output
        _check(name, got.shape == want.shape and got.dtype == want.dtype
               and bool((diff <= ulp).all()), f"max err {float(diff.max())}")
        return float(diff.max())

    def sdpa_args(win, c, heads, bias, mask):
        """q, k, v (nw, heads, 49, hd) and the additive mask, bf16."""
        nw = win.shape[0]
        q, k, v = (win[..., i * c:(i + 1) * c].reshape(nw, l, heads, c // heads)
                   .transpose(1, 2).contiguous() for i in range(3))
        am = bias[None] if mask is None else bias[None] + mask[:, None]
        return q, k, v, am.to(torch.bfloat16).expand(nw, -1, -1, -1).contiguous()

    def flops(nw, heads, hd):
        return 4.0 * nw * heads * l * l * hd  # QK^T and PV, 2 operations a multiply-add

    def row(name, kernel, replaces, stage, hp, wp, c, heads, image: bool):
        """One kernel at one stage: checked and timed with the mask and
        without.  K8 takes the image, K7 its partitioned windows."""
        qkv_img, bias, mask = inputs(hp, wp, c, heads)
        x = qkv_img if image else window_partition(qkv_img, ws).contiguous()
        if image:
            run = lambda m: window_attn.window_attention(x, bias, m, heads, ws)  # noqa: E731
            plain = lambda m: window_attn.window_attention_plain(x, bias, m, heads, ws)  # noqa: E731
        else:
            run = lambda m: window_attn.window_attn_math(x, bias, m, heads)  # noqa: E731
            plain = lambda m: window_attn.window_attn_math_plain(x, bias, m, heads)  # noqa: E731
        nw = (hp // ws) * (wp // ws)
        err, timed = 0.0, {}
        for tag, m in (("", mask), ("_no_mask", None)):
            got = run(m)
            want = plain(m)
            err = max(err, checked(f"{name}{tag}", got, want))
            del want
            args = sdpa_args(window_partition(qkv_img, ws), c, heads, bias, m)
            timed[f"ms{tag}"] = _time_ms(lambda: run(m))
            timed[f"plain_ms{tag}"] = _time_ms(lambda: plain(m), reps=5)
            timed[f"library_ms{tag}"] = _time_ms(
                lambda: F.scaled_dot_product_attention(*args[:3], attn_mask=args[3]))
            del args
            bound = _bound(_nbytes(x, bias, got, *([] if m is None else [m])),
                           flops(nw, heads, c // heads), "bf16")
            timed.update({f"{k}{tag}": v for k, v in bound.items()})
        return dict(
            name=name, kernel=kernel, route="cuda",
            source="polyphonicformer_torch/csrc/window_attn.cu", replaces=replaces,
            max_abs_err=err, **timed,
            shape=f"stage {stage}: qkv {tuple(x.shape)} bf16, mask {tuple(mask.shape)} f32")

    k8 = "polyphonicformer_tpu/ops/pallas/window_attn.py:84"
    k7 = "polyphonicformer_tpu/ops/pallas/win_attn_math.py:78"
    return [row("window_attention", "window_attention", k8, 0, 259, 518, 192, 6, True),
            row("window_attention_stage1", "window_attention", k8, 1, 133, 259, 384, 12, True),
            row("window_attn_math", "window_attn_math", k7, 2, 70, 133, 768, 24, False),
            row("window_attn_math_stage3", "window_attn_math", k7, 3, 35, 70, 1536, 48, False)]


GRAD_RTOL = 1e-5  # K7/K8 gradients: same VJP, sums possibly in another order


def check_window_grads(dev, gen) -> dict:
    """Phase 3: K8 at Swin-L stage 0 and K7 at stage 2 (bf16 qkv, with the
    shift mask and without) through their autograd Functions on the card
    (forward the kernel, backward the plain version's VJP) against autograd
    of the plain versions on the same inputs and cotangent: the output
    carries a ``grad_fn``, and the qkv and bias gradients lie within
    GRAD_RTOL x max |plain| of each.  Returns the worst error over max
    |plain| per kernel."""
    import torch

    from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition
    from polyphonicformer_torch.ops.cuda import window_attn

    ws, l = 7, 49
    worst = {}
    for name, hp, wp, c, heads in (("window_attention", 259, 518, 192, 6),
                                   ("window_attn_math", 70, 133, 768, 24)):
        qkv = torch.randn((1, hp, wp, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((heads, l, l), generator=gen, device=dev) * 0.5
        if name == "window_attn_math":
            qkv = window_partition(qkv, ws).contiguous()
            run, plain = window_attn.window_attn_math, window_attn.window_attn_math_plain
            extra = ()
        else:
            run, plain = window_attn.window_attention, window_attn.window_attention_plain
            extra = (ws,)
        shift = torch.from_numpy(_shift_attn_mask(hp, wp, ws, 3)).to(dev)
        for tag, mask in (("", shift), (" no mask", None)):
            g = None
            grads = []
            for fn in (run, plain):
                q = qkv.clone().requires_grad_(True)
                b = bias.clone().requires_grad_(True)
                y = fn(q, b, mask, heads, *extra)
                if fn is run:
                    _check(f"{name}{tag} grad_fn", y.grad_fn is not None, "no grad_fn")
                if g is None:
                    g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
                y.backward(g)
                grads.append((q.grad.float(), b.grad))
            for leaf, got, want in zip(("qkv", "bias"), *grads):
                rel = float((got - want).abs().max()) / float(want.abs().max())
                _check(f"{name}{tag} d{leaf}", rel <= GRAD_RTOL, f"max err {rel} of max |plain|")
                worst[name] = max(worst.get(name, 0.0), rel)
            del grads, g
    return {"max_err_of_max_plain": worst, "tolerance": GRAD_RTOL}


def check_train_kernels(dev, gen) -> list[dict]:
    """Phase 3, training shapes: K2b, K5, K6 and K6b against their plain
    versions at the shapes of the image-model train step at 1024x2048."""
    import torch

    from polyphonicformer_torch.ops.cuda import lsa, upsample2
    from polyphonicformer_torch.ops.hungarian import match_gt_to_preds_batched
    from polyphonicformer_torch.tools import kernel_probe

    rows = []
    # K2b: gradients of the x2 upsamples of (1+3 stages x 111) mask logits
    # and of the 19 semantic logits, bit-equal
    err = 0.0
    for n in (444, 19):
        g = torch.randn((n, 256, 512), generator=gen, device=dev)
        got = upsample2._upsample_int_bwd_cuda(g, 2, 2)
        torch.cuda.synchronize()
        err = max(err, _exact(f"upsample bwd n={n}", got,
                              upsample2.upsample_int_bwd_plain(g, 2, 2)))
        if n == 444:
            g444, dx444 = g, got
    lib_args = (g444[:, None], [256, 512], [444, 1, 128, 256], False, 2.0, 2.0)
    rows.append(dict(
        name="upsample2_bwd", route="cuda", source="polyphonicformer_torch/csrc/upsample.cu",
        replaces="polyphonicformer_tpu/ops/pallas/upsample2.py:172", max_abs_err=err,
        ms=_time_ms(lambda: upsample2._upsample_int_bwd_cuda(g444, 2, 2)),
        plain_ms=_time_ms(lambda: upsample2.upsample_int_bwd_plain(g444, 2, 2)),
        library_ms=_time_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(*lib_args)),
        **_bound(_nbytes(g444, dx444))))

    # K5: 16 seeded (64 GT x 100 predictions) problems, 12-40 valid rows
    # each, some invalid rows between valid ones; raw costs, handed over as
    # the assignment hands them: a transposed view of (16, 100, 64)
    costs = torch.randn((16, 64, 100), generator=gen, device=dev) * 2
    counts = torch.randint(12, 41, (16,), generator=gen, device=dev)
    valid = torch.arange(64, device=dev)[None] < counts[:, None]
    holes = torch.rand((16, 64), generator=gen, device=dev) < 0.15
    valid = valid & ~(holes & (torch.arange(64, device=dev) < 10))
    raw = costs.transpose(1, 2).contiguous().transpose(1, 2)
    got = match_gt_to_preds_batched(raw, valid)
    torch.cuda.synchronize()
    steps = []
    want = lsa.solve_lsa_plain(raw.cpu(), valid.cpu(), steps)
    _check("lsa", torch.equal(got.cpu(), want), "assignments differ from the plain solver")
    _check("lsa", torch.equal(lsa.solve_lsa(raw, valid), got), "two launches differ")
    # its latency bound: the longest problem's Dijkstra steps x one warp-wide
    # argmin step (tools/kernel_probe.py)
    step_us = kernel_probe.warp_step_us(dev, 16, 100)
    ms = _time_ms(lambda: lsa.solve_lsa(raw, valid))
    rows.append(dict(
        name="lsa", route="cuda", source="polyphonicformer_torch/csrc/lsa.cu",
        replaces="polyphonicformer_tpu/ops/pallas/lsa.py:133", max_abs_err=0.0, ms=ms,
        plain_ms=_time_ms(lambda: lsa.solve_lsa_plain(raw, valid), reps=3),
        library_ms=None, **_bound(_nbytes(raw, valid, got)),
        dijkstra_steps_longest=max(steps), warp_argmin_step_us=step_us,
        latency_bound_us=max(steps) * step_us,
        latency_bound_share=max(steps) * step_us / (ms * 1e3)))

    # K6 / K6b on the three refinement stages' mask volume and on the rpn
    # head's, the train step's two calls
    for shape, sfx in (((3, 111, 256, 512), ""), ((1, 100, 256, 512), "_n100")):
        rows += mask_loss_rows(dev, gen, shape, sfx)
    return rows


def mask_loss_rows(dev, gen, shape, sfx: str) -> list[dict]:
    """K6 and K6b at one shape: stats and dice within rtol 1e-5 of the plain
    version, the saved lse bit-equal to the plain version's, equal bits on
    a second launch, dm within 1e-7 + 1e-5|x| of the plain gradient given
    the same lse.  The bounds count the function's inputs and outputs, not
    the lse the forward saves for the backward (1.5 MB at the stages'
    shape, 0.3% of either bound)."""
    import torch

    from polyphonicformer_torch.ops.cuda import mask_loss

    n, q, h, w = shape
    m = torch.randn(shape, generator=gen, device=dev) * 3
    t = (torch.rand(shape, generator=gen, device=dev) < 0.2).float()
    pos = (torch.rand(shape[:2], generator=gen, device=dev) < 0.3).float()
    v = (torch.rand((n, h, w), generator=gen, device=dev) < 0.9).float()
    lbl = torch.randint(0, q, (n, h, w), generator=gen, device=dev, dtype=torch.int32)
    lbl[torch.rand((n, h, w), generator=gen, device=dev) < 0.2] = 255
    out = mask_loss._stats_cuda(m, t, pos, v, lbl)
    again = mask_loss._stats_cuda(m, t, pos, v, lbl)
    torch.cuda.synchronize()
    stats, dice, lse = out
    ws, wd, wl = mask_loss.mask_loss_stats_plain(m, t, pos, v, lbl)
    name = f"mask_loss{sfx}"
    err = 0.0
    for part, a, b in (("stats", stats, ws), ("dice", dice, wd)):
        diff = (a - b).abs()
        _check(f"{name} {part}", bool((diff <= 1e-5 * b.abs()).all()),
               f"max rel err {float((diff / b.abs().clamp(min=1e-30)).max())}")
        err = max(err, float(diff.max()))
    _exact(f"{name} lse", lse, wl)
    _check(name, all(torch.equal(a, b) for a, b in zip(out, again)), "two launches differ")
    rows = [dict(
        name=name, kernel="mask_loss", route="cuda",
        source="polyphonicformer_torch/csrc/mask_loss.cu",
        replaces="polyphonicformer_tpu/ops/pallas/mask_loss.py:142", max_abs_err=err,
        lse_bit_equal=True, ms=_time_ms(lambda: mask_loss._stats_cuda(m, t, pos, v, lbl)),
        plain_ms=_time_ms(lambda: mask_loss.mask_loss_stats_plain(m, t, pos, v, lbl)),
        library_ms=None, shape=f"{shape} f32",
        **_bound(_nbytes(m, t, pos, v, lbl, stats, dice)))]
    del ws, wd, again
    gs = torch.randn((n, 2), generator=gen, device=dev)
    gd = torch.randn((n, 3, q), generator=gen, device=dev)
    dm = mask_loss._grad_cuda(m, t, pos, v, lbl, gs, gd, lse)
    torch.cuda.synchronize()
    want = mask_loss.mask_loss_grad_plain(m, t, pos, v, lbl, gs, gd, wl)
    diff = (dm - want).abs()
    _check(f"{name} dm", bool((diff <= 1e-7 + 1e-5 * want.abs()).all()),
           f"max err {float(diff.max())}")
    err = float(diff.max())
    del want, diff
    rows.append(dict(
        name=f"mask_loss_bwd{sfx}", kernel="mask_loss_bwd", route="cuda",
        source="polyphonicformer_torch/csrc/mask_loss.cu",
        replaces="polyphonicformer_tpu/ops/pallas/mask_loss.py:162", max_abs_err=err,
        ms=_time_ms(lambda: mask_loss._grad_cuda(m, t, pos, v, lbl, gs, gd, lse)),
        plain_ms=_time_ms(lambda: mask_loss.mask_loss_grad_plain(m, t, pos, v, lbl, gs, gd, wl)),
        library_ms=None, shape=f"{shape} f32",
        **_bound(_nbytes(m, t, pos, v, lbl, gs, gd, dm))))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    import polyphonicformer_torch  # noqa: F401  (fails outside the repo)
    from polyphonicformer_torch.ops.cuda import _lib

    # the f32 comparisons hold full f32 math: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = _nvidia_smi()
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _lib.load()
    built = ("already built for these sources" if _lib.build_seconds is None
             else f"nvcc {_lib.build_seconds:.2f} s")
    print(f"[2 build] {_lib.library_path().name}: {built}, "
          f"build and load {time.perf_counter() - t0:.2f} s", flush=True)
    # the bf16 window-attention kernels (K7, K8: head dims rounded up to 16, 32,
    # 48, 64) and K1 run on the tensor cores
    tc = _tensor_core_ops(_lib.library_path())
    wa = {k: n for k, n in tc.items() if k.startswith("window_attn_mma_kernel")}
    _check("tensor cores", len(wa) == 8 and min(wa.values()) > 0
           and any(k.startswith("mask_pool") for k in tc), f"HMMA/HGMMA per kernel {tc}")
    print(f"[2 build] tensor-core instructions (cuobjdump -sass): {json.dumps(tc)}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = check_kernels(dev, gen) + check_train_kernels(dev, gen) + check_swin_kernels(dev, gen)
    print(f"[3 grad] K7/K8 gradients on the card against the plain versions' autograd: "
          f"{json.dumps(check_window_grads(dev, gen))}", flush=True)
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[3 kernel] {r['name']}: max_abs_err {r['max_abs_err']} | kernel {r['ms']:.4f} ms "
              f"| plain {r['plain_ms']:.4f} ms | library {lib} | bound {r['bound_us']:.2f} us "
              f"({r['bound_by']})", flush=True)
        if "latency_bound_us" in r:
            print(f"[3 kernel] {r['name']}: latency bound {r['latency_bound_us']:.2f} us "
                  f"({r['dijkstra_steps_longest']} Dijkstra steps x {r['warp_argmin_step_us']:.4f}"
                  f" us a warp argmin step), {100 * r['latency_bound_share']:.1f}% of the kernel's "
                  f"time", flush=True)

    serve_launches, slice_info = run_slice(dev)
    print(f"[4 slice] {json.dumps(slice_info)}", flush=True)
    train_launches, train_info = run_train(dev)
    print(f"[5 train] {json.dumps(train_info)}", flush=True)
    swin_launches, swin_info = run_swin(dev)
    print(f"[6 swin] {json.dumps(swin_info)}", flush=True)
    video_launches, video_info = run_video(dev)
    print(f"[7 video] {json.dumps(video_info)}", flush=True)
    eval_launches, eval_info = run_eval(dev)
    print(f"[8 eval] {json.dumps(eval_info)}", flush=True)
    for r in rows:
        kernel = r.pop("kernel", r["name"])  # rows at several shapes share a kernel
        by_path = {"serve": serve_launches.get(kernel, 0),
                   "train": train_launches.get(kernel, 0),
                   "swin": swin_launches.get(kernel, 0),
                   "video": video_launches.get(kernel, 0),
                   "eval": eval_launches.get(kernel, 0)}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        _check(f"launches {r['name']}", r["launches"] > 0, "never launched on a main path")

    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


PER_FRAME = {"mask_pool": 7, "upsample2": 4, "phase_fusion": 1, "map_render": 1}
# Swin-L: K8 in the 4 blocks of stages 0-1 (6 and 12 heads), K7 in the 20
# of stages 2-3 (24 and 48 heads)
SWIN_PER_FRAME = {**PER_FRAME, "window_attention": 4, "window_attn_math": 20}


def swin_per_batched_step(b: int) -> dict:
    """Launches of one batched step over b clips: one network forward (its
    K1, K7, K8 and three x2 upsamples once), then per clip the x4 dense
    depth (K2), fusion (K3) and rendering (K4)."""
    return {**SWIN_PER_FRAME, "upsample2": 3 + b, "phase_fusion": b, "map_render": b}
# per train step: K1 once in the rpn head and twice per stage; one x2
# upsample each of the stacked masks, the semantic logits, the dense depth
# and the stacked stage depths, forward and backward; one batched solve; the
# mask losses of the rpn and of the stacked stages, forward and backward
PER_STEP = {"mask_pool": 7, "upsample2": 4, "upsample2_bwd": 4, "lsa": 1, "mask_loss": 2,
            "mask_loss_bwd": 2}
# a video train step launches PER_STEP too: the key frame's launches are an
# image step's; the ref frame runs only the backbone and FPN, the GT boxes
# are matmuls of the marginals and the track head RoIAlign, convolutions and
# linears.  video_swinl adds K8 in the 4 blocks of stages 0-1 and K7 in the
# 20 of stages 2-3, each launched by the key frame's forward, the ref
# frame's no-grad forward and the key backbone's recomputation under
# torch.utils.checkpoint in the backward; their backward is the plain
# versions' VJP, no kernel
SWIN_VIDEO_PER_STEP = {**PER_STEP, "window_attention": 3 * 4, "window_attn_math": 3 * 20}


def _kernels():
    from polyphonicformer_torch.ops.cuda import (lsa, map_render, mask_loss, mask_pool,
                                                 phase_fusion, upsample2, window_attn)

    return {"mask_pool": mask_pool.KERNEL, "upsample2": upsample2.KERNEL,
            "upsample2_bwd": upsample2.KERNEL_BWD, "phase_fusion": phase_fusion.KERNEL,
            "map_render": map_render.KERNEL, "lsa": lsa.KERNEL, "mask_loss": mask_loss.KERNEL,
            "mask_loss_bwd": mask_loss.KERNEL_BWD,
            "window_attn_math": window_attn.KERNEL_MATH,
            "window_attention": window_attn.KERNEL_IMAGE}


def _count_launches(kernels, per: dict, times: int, tag: str) -> dict:
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        _check(f"{tag} launches {name}", n == per.get(name, 0) * times,
               f"{n} launches, expected {per.get(name, 0)} x {times}")
    return launches


def _check_maps(tag: str, out, cfg, shape) -> None:
    """Map shapes and types, classes in range, finite depth in [0, 80] m,
    track ids only on thing pixels."""
    import torch

    nc, nt = cfg.num_classes, cfg.num_thing_classes
    for field, dtype in (("semantic", torch.int32), ("panoptic", torch.int32),
                         ("track_map", torch.int32), ("depth", torch.float32)):
        v = getattr(out, field)
        _check(f"{tag} {field}", v.shape == shape and v.dtype == dtype,
               f"{tuple(v.shape)} {v.dtype}")
    _check(f"{tag} semantic range", int(out.semantic.min()) >= 0
           and int(out.semantic.max()) <= nc,
           f"[{int(out.semantic.min())}, {int(out.semantic.max())}]")
    _check(f"{tag} depth", bool(torch.isfinite(out.depth).all()) and float(out.depth.min()) >= 0
           and float(out.depth.max()) <= 80.0,
           f"[{float(out.depth.min())}, {float(out.depth.max())}]")
    _check(f"{tag} track ids on things", not bool((out.track_map[out.semantic >= nt] != 0).any()),
           "track id on a stuff or void pixel")


def _frames(gen, t, h, w, block, dev):
    """Colour blocks plus per-frame noise, so segments persist across frames."""
    import torch

    base = torch.randn((1, h // block, w // block, 3), generator=gen, device=dev) * 2
    base = base.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return base + 0.1 * torch.randn((t, h, w, 3), generator=gen, device=dev)


def check_small_reference(dev) -> dict:
    """The serving path on the card (kernels) against the same path on the
    CPU (plain versions) at the tiny widths, 64x128, same weights and
    frames: maps on >= 99.9% of pixels, tracker ids equal."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import clip_video_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", max_per_img=100)
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.roi_head.mask_head[-1].fc_cls.bias.zero_()
    gpu = build_model(cfg, dev, state_dict=cpu.state_dict())
    frames = _frames(torch.Generator().manual_seed(0), 3, 64, 128, 16, "cpu")
    agree = {}
    for name, fusion in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        outs = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, device)
            out, state = clip_video_step(model, cfg, frames.to(device), state, 1, (64, 128),
                                         fusion_dtype=fusion)
            outs.append((out, state))
        (oc, sc), (og, sg) = outs
        for field in ("semantic", "panoptic", "track_map"):
            frac = float((getattr(oc, field) == getattr(og, field).cpu()).float().mean())
            agree[f"{name}.{field}"] = frac
            _check(f"small reference {name} {field}", frac >= 0.999, f"agree {frac}")
        _check(f"small reference {name} tracker", torch.equal(sc.ids, sg.ids.cpu()),
               f"{sc.ids.tolist()} vs {sg.ids.cpu().tolist()}")
    return agree


def _serve_clip(tag: str, model, cfg, frames, per_frame: dict, dev):
    """An 8-frame clip through ``make_clip_step`` (bf16), counted and
    checked; then a warm pass of the clip and the same frames one by one
    through ``make_video_step``, each frame timed with CUDA events."""
    import torch

    from polyphonicformer_torch.infer.pipeline import make_clip_step, make_video_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state

    kernels = _kernels()
    t, h, w = frames.shape[:3]
    bf16 = torch.bfloat16
    step = make_clip_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out, state = step(frames, state0, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _count_launches(kernels, per_frame, t, tag)
    _check_maps(tag, out, cfg, (t, h, w))
    # new tracklets come only from valid detections that reached tracker_step
    _check(f"{tag} detections", int(state.num_tracklets) > 0 and bool((out.track_map > 0).any()),
           "no detection reached the tracker")
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    step(frames, state0, 1)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    frame_step = make_video_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)
    frame_ms, st = [], state0
    for i in range(t):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, st = frame_step(frames[i:i + 1], st, i + 1)
        b.record()
        b.synchronize()
        frame_ms.append(a.elapsed_time(b))
    frame_ms.sort()
    median = frame_ms[len(frame_ms) // 2]
    return launches, {
        "preset": cfg.backbone, "hw": [h, w], "frames": t, "dtype": "bfloat16",
        "first_pass_s": first_s, "warm_clip_s": clip_s, "warm_clip_fps": t / clip_s,
        "median_frame_ms": median, "median_fps": 1000.0 / median, "frame_ms": frame_ms,
        "peak_mem_gib": peak / 2 ** 30, "num_tracklets": int(state.num_tracklets),
        "frames_with_tracks": int((out.track_map > 0).flatten(1).any(1).sum()),
        "launches": launches}


def _serving_model(preset: str, dev):
    """The preset's model on the card, weights drawn from seed 0."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.models import build_model

    cfg = model_preset(preset)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(cfg, dev, generator=gen)
    with torch.no_grad():  # thing scores straddle instance_score_thr
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    return cfg, model, gen


def run_slice(dev):
    """Phase 4: the R50 video serving path at full width, bf16."""
    import torch

    from polyphonicformer_torch.infer.pipeline import make_image_step

    cfg, model, gen = _serving_model("video_r50_1x", dev)
    h, w = 1024, 2048
    frames = _frames(gen, 8, h, w, 64, dev)
    launches, info = _serve_clip("r50 clip", model, cfg, frames, PER_FRAME, dev)
    info["preset"] = "video_r50_1x"

    # image mode, a prefix of the same code
    bf16 = torch.bfloat16
    pano = make_image_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)(frames[:1])
    _check("image step", pano.semantic.shape == (h, w)
           and int(pano.semantic.max()) <= cfg.num_classes
           and bool(torch.isfinite(pano.depth).all()), "image-mode maps")
    info["small_reference_agree"] = check_small_reference(dev)
    return launches, info


def check_swin_small_reference(dev) -> dict:
    """A debug-width swin_tiny model at 64x128, f32: the forward on the card
    (K7, K8) against the same forward on the CPU (their plain versions),
    same weights and image.  Each output within 1e-4 x max |cpu| (f32 sums
    in another order)."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", backbone="swin_tiny")
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    gpu = build_model(cfg, dev, state_dict=cpu.state_dict())
    img = torch.randn((1, 64, 128, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = {name: (m.extract_feat(x), m(x)) for name, m, x in
                (("cpu", cpu, img), ("gpu", gpu, img.to(dev)))}
    (fc, oc), (fg, og) = outs["cpu"], outs["gpu"]
    pairs = [(f"P{i + 2}", a, b) for i, (a, b) in enumerate(zip(fc, fg))]
    pairs += [(f, getattr(oc.stages[-1], f), getattr(og.stages[-1], f))
              for f in ("cls_score", "mask_preds", "depth_preds")]
    worst = {}
    for name, a, b in pairs:
        rel = float((a - b.cpu()).abs().max()) / float(a.abs().max())
        worst[name] = rel
        _check(f"swin small reference {name}", rel <= 1e-4, f"max err {rel} of max |cpu|")
    return worst


def run_swin(dev):
    """Phase 6: the Swin-L video serving path at full width, bf16: an 8-frame
    clip, then the batched step over 2 clips for 3 frames."""
    import torch

    from polyphonicformer_torch.infer.pipeline import (init_batched_tracker_states,
                                                       make_batched_video_step)

    cfg, model, gen = _serving_model("video_swinl", dev)
    _check("video_swinl dtype", cfg.compute_dtype == "bfloat16", cfg.compute_dtype)
    h, w, t, b = 1024, 2048, 8, 2
    frames = _frames(gen, t, h, w, 64, dev)
    launches, info = _serve_clip("swin clip", model, cfg, frames, SWIN_PER_FRAME, dev)
    info["preset"] = "video_swinl"

    # batched: clip 0 is the start of the clip above, clip 1 its next
    # frames mirrored left to right
    steps = 3
    clips = torch.stack([frames[:steps], frames[steps:2 * steps].flip(2)], dim=1)
    bf16 = torch.bfloat16
    step = make_batched_video_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)
    states = init_batched_tracker_states(cfg, b, dev)
    kernels = _kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    step_s = []
    for i in range(steps):
        t0 = time.perf_counter()
        out, states = step(clips[i], states, [i + 1, i + 1])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        _check_maps(f"swin batched step {i}", out, cfg, (b, h, w))
    per_step = swin_per_batched_step(b)
    batched = _count_launches(kernels, per_step, steps, "swin batched")
    _check("swin batched detections", int(states.num_tracklets.sum()) > 0,
           "no detection reached a tracker")
    warm_ms = [s * 1e3 for s in step_s[1:]]
    info["batched"] = {
        "clips": b, "steps": steps, "first_step_s": step_s[0], "warm_steps_ms": warm_ms,
        "warm_frames_per_s": b * len(warm_ms) / sum(step_s[1:]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "num_tracklets": states.num_tracklets.tolist(), "launches_per_step": per_step}
    info["small_reference_max_rel_err"] = check_swin_small_reference(dev)
    return {name: launches[name] + batched[name] for name in launches}, info


def check_train_reference(dev) -> dict:
    """One debug_tiny train step at 64x128 on the card (kernels) against the
    same step on the CPU (plain versions), same weights and batch:
    assignments equal, every loss within rtol 1e-4."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("debug_tiny")
    cpu = build_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(0))
    sides = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        model = build_model(cfg.model, device, state_dict=cpu.state_dict())
        state, opt = create_train_state(model, cfg, None, device=device)
        batch = synthetic_batch(cfg.model, 1, (64, 128), seed=0, max_instances=6,
                                device=device)
        with torch.no_grad():
            asg = losses.assign(cfg.model, state.model(batch.image), batch.gt)
        _, metrics = make_train_step(state.model, cfg, opt)(state, batch)
        sides[name] = ([a.gt2pred.cpu() for a in asg.assigns],
                       {k: float(v) for k, v in metrics.items()})
    (ac, mc), (ag, mg) = sides["cpu"], sides["gpu"]
    _check("train reference assignments", all(torch.equal(a, b) for a, b in zip(ac, ag)),
           "the card's assignments differ from the CPU's")
    worst = 0.0
    for k, v in mc.items():
        rel = abs(mg[k] - v) / max(abs(v), 1e-6)
        worst = max(worst, rel)
        _check(f"train reference {k}", rel <= 1e-4, f"{mg[k]} vs {v}")
    return {"max_rel_err": worst, "total_loss": mg["total_loss"]}


SWIN_GRAD_RTOL = 1e-4  # per leaf, of max |reference grad|; losses and grad_norm relative


def check_swin_train_reference(dev) -> dict:
    """One debug_tiny train step with the swin_tiny backbone at 64x128 on
    the same weights and batch four ways: on the card in f32 through K7 and
    K8 (forward the kernels, backward their plain versions' VJP), on the
    card with the plain versions in their place, on the CPU in f32, and on
    the CPU in f64, the reference (parameters, image and activations in f64
    except where the model casts to f32: LayerNorm, the attention's plain
    version, the losses).  Checks: K7 and K8 launch; assignments equal; the
    same parameters get a gradient; on the card through the kernels every
    loss and the grad_norm within SWIN_GRAD_RTOL of the f64 step, and each
    gradient (after the step's clipping) within SWIN_GRAD_RTOL x max |f64|
    of the f64 step's and of the card's plain route's.  The f32 CPU step's
    distance from the f64 step is reported beside them: it says whether
    the card or the CPU departs where the two f32 steps disagree."""
    import dataclasses

    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.ops.cuda import window_attn
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("debug_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="swin_tiny"))
    cpu = build_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(0))
    kernels = (window_attn.KERNEL_IMAGE, window_attn.KERNEL_MATH)
    fwd = (window_attn._window_attn_math_fwd, window_attn._window_attention_fwd)

    def step(device, dtype=torch.float32):
        model = build_model(cfg.model, device, state_dict=cpu.state_dict())
        state, opt = create_train_state(model, cfg, None, device=device)
        state.model.to(dtype)
        for st in opt.adamw.state.values():
            st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].to(dtype), st["exp_avg_sq"].to(dtype)
        batch = synthetic_batch(cfg.model, 1, (64, 128), seed=0, max_instances=6,
                                device=device)
        batch = batch._replace(image=batch.image.to(dtype))
        with torch.no_grad():
            asg = losses.assign(cfg.model, state.model(batch.image), batch.gt)
        before = [k.launches for k in kernels]
        _, metrics = make_train_step(state.model, cfg, opt)(state, batch)
        grads = {n: p.grad.detach().double().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        return ([a.gt2pred.cpu() for a in asg.assigns], {k: float(v) for k, v in metrics.items()},
                grads, [k.launches - b for k, b in zip(kernels, before)])

    runs = {"f64": step("cpu", torch.float64), "cpu": step("cpu"), "kernels": step(dev)}
    window_attn._window_attn_math_fwd = lambda q, b, m, h: window_attn.window_attn_math_plain(
        q, b, m, h)
    window_attn._window_attention_fwd = lambda q, b, m, h, ws: (
        window_attn.window_attention_plain(q, b, m, h, ws))
    try:
        runs["plain"] = step(dev)
    finally:
        window_attn._window_attn_math_fwd, window_attn._window_attention_fwd = fwd
    launched = runs["kernels"][3]
    _check("swin train launches", min(launched) > 0, f"K8, K7 launched {launched}")
    ref_asg, ref_metrics, ref_grads, _ = runs["f64"]
    _check("swin train assignments", all(
        torch.equal(a, b) for run in runs.values() for a, b in zip(ref_asg, run[0])),
        "an f32 step's assignments differ from the f64 step's")
    metric_err = {}
    for key, (_, metrics, grads, _) in runs.items():
        metric_err[key] = {k: abs(metrics[k] - v) / max(abs(v), 1e-6)
                           for k, v in ref_metrics.items()}
        _check(f"swin train {key} gradients", set(grads) == set(ref_grads)
               and any("w_msa.qkv" in n for n in grads),
               f"only {key}: {sorted(set(grads) - set(ref_grads))[:4]}, "
               f"only f64: {sorted(set(ref_grads) - set(grads))[:4]}")
    for k, v in metric_err["kernels"].items():
        _check(f"swin train {k}", v <= SWIN_GRAD_RTOL,
               f"{runs['kernels'][1][k]} on the card, {ref_metrics[k]} in f64")
    pairs = {"kernels_vs_f64": ("kernels", "f64"), "plain_vs_f64": ("plain", "f64"),
             "cpu_f32_vs_f64": ("cpu", "f64"), "kernels_vs_plain": ("kernels", "plain"),
             "kernels_vs_cpu_f32": ("kernels", "cpu")}
    worst = {key: (0.0, "") for key in pairs}
    for n, want in ref_grads.items():
        scale = float(want.abs().max())
        rel = {key: float((runs[a][2][n] - runs[b][2][n]).abs().max()) / scale
               for key, (a, b) in pairs.items()}
        worst = {key: max(worst[key], (v, n)) for key, v in rel.items()}
        _check(f"swin train grad {n}", rel["kernels_vs_f64"] <= SWIN_GRAD_RTOL
               and rel["kernels_vs_plain"] <= SWIN_GRAD_RTOL,
               f"max err over max |f64|: {rel}")
    return {"leaves": len(ref_grads), "tolerance": SWIN_GRAD_RTOL,
            "max_grad_err_of_max_f64": {k: v for k, (v, _) in worst.items()},
            "worst_leaf": {k: n for k, (_, n) in worst.items()},
            "max_metric_rel_err_to_f64": {k: max(v.values()) for k, v in metric_err.items()},
            "grad_norm": {k: run[1]["grad_norm"] for k, run in runs.items()},
            "k8_k7_launches": launched, "total_loss": runs["kernels"][1]["total_loss"]}


def run_train(dev):
    """Phase 5: the image-model train step at full width, 1024x2048, B=1."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    kernels = _kernels()
    cfg = preset("image_r50_2x")
    h, w, steps = 1024, 2048, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt)
    batch = synthetic_batch(cfg.model, 1, (h, w), seed=0, max_instances=24, device=dev)
    frozen = state.model.backbone.conv1.weight.detach().clone()
    trained = state.model.backbone.layer2[0].conv1.weight.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.values():
        k.launches = 0
    step_s, all_metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    launches = _count_launches(kernels, PER_STEP, steps, "train")
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(all_metrics):
        _finite_metrics(f"train step {i}", m)
    _check("frozen conv1", torch.equal(state.model.backbone.conv1.weight, frozen),
           "a frozen parameter moved")
    _check("trainable layer2", not torch.equal(state.model.backbone.layer2[0].conv1.weight,
                                               trained), "a trainable parameter did not move")
    _check("step counter", int(state.step) == steps, f"{int(state.step)}")

    # one more step in stages, each closed by a synchronize (not counted)
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    t = time.perf_counter()
    opt.zero_grad()
    out = state.model(batch.image)
    t = mark("forward", t)
    asg = losses.assign(cfg.model, out, batch.gt)
    t = mark("assignment", t)
    total, _ = losses.losses_from(cfg.model, out, batch.gt, asg)
    t = mark("losses", t)
    total.backward()
    t = mark("backward", t)
    opt.clip_grads()
    opt.step()
    mark("optimizer", t)

    return launches, {
        "preset": "image_r50_2x", "hw": [h, w], "batch": 1, "dtype": "float32",
        "max_instances": 24, "cold_step_s": step_s[0],
        "warm_steps_ms": [s * 1e3 for s in step_s[1:]],
        "median_warm_step_ms": statistics.median(s * 1e3 for s in step_s[1:]),
        "stages_ms": stages, "peak_mem_gib": peak / 2 ** 30,
        "total_loss": [m["total_loss"] for m in all_metrics],
        "grad_norm": [m["grad_norm"] for m in all_metrics],
        "launches": launches, "small_reference": check_train_reference(dev),
        "swin_small_reference": check_swin_train_reference(dev),
    }


def _finite_metrics(tag: str, metrics: dict) -> None:
    bad = [k for k, v in metrics.items() if v != v or abs(v) == float("inf")]
    _check(f"{tag} losses", not bad, f"non-finite {bad}")
    _check(f"{tag} guard", metrics["skipped_nonfinite"] == 0.0, "step skipped")


VIDEO_RTOL = 1e-4  # the small video step on the card against f64: losses, grad_norm
VIDEO_HW = (1024, 2048)  # phase 7's image size


def check_video_train_reference(dev) -> dict:
    """One debug_tiny_video step (2 frames, 64x128) on the same weights and
    batch three ways: on the card in f32 (kernels), on the CPU in f32 and
    on the CPU in f64, the reference (parameters, images and activations in
    f64 except where the model casts to f32).  Checks: the card step
    launches exactly PER_STEP; assignments equal; every loss and the
    grad_norm within VIDEO_RTOL of the f64 step.  The f32 CPU step's
    distance from f64 is reported beside it."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    cfg = preset("debug_tiny_video")
    cpu = build_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(0))
    kernels = _kernels()

    def step(device, dtype=torch.float32):
        model = build_model(cfg.model, device, state_dict=cpu.state_dict())
        state, opt = create_train_state(model, cfg, None, device=device)
        state.model.to(dtype)
        for st in opt.adamw.state.values():
            st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].to(dtype), st["exp_avg_sq"].to(dtype)
        batch = synthetic_batch(cfg.model, 1, (64, 128), two_frame=True, seed=0,
                                max_instances=6, device=device)
        batch = batch._replace(image=batch.image.to(dtype), ref_image=batch.ref_image.to(dtype))
        with torch.no_grad():
            asg = losses.assign(cfg.model, state.model(batch.image), batch.gt)
        for k in kernels.values():
            k.launches = 0
        _, metrics = make_train_step(state.model, cfg, opt, video=True)(state, batch)
        launches = {name: k.launches for name, k in kernels.items()}
        return [a.gt2pred.cpu() for a in asg.assigns], {k: float(v) for k, v in metrics.items()}, \
            launches

    runs = {"f64": step("cpu", torch.float64), "cpu_f32": step("cpu"), "card": step(dev)}
    _check("video reference launches",
           all(runs["card"][2][k] == PER_STEP.get(k, 0) for k in kernels),
           f"{runs['card'][2]}")
    ref_asg, ref_metrics, _ = runs["f64"]
    _check("video reference assignments", all(
        torch.equal(a, b) for run in runs.values() for a, b in zip(ref_asg, run[0])),
        "an f32 step's assignments differ from the f64 step's")
    err = {key: {k: abs(run[1][k] - v) / max(abs(v), 1e-6) for k, v in ref_metrics.items()}
           for key, run in runs.items() if key != "f64"}
    for k, v in err["card"].items():
        _check(f"video reference {k}", v <= VIDEO_RTOL,
               f"{runs['card'][1][k]} on the card, {ref_metrics[k]} in f64")
    return {"tolerance": VIDEO_RTOL,
            "max_metric_rel_err_to_f64": {key: max(e.values()) for key, e in err.items()},
            "worst_metric": {key: max(e, key=e.get) for key, e in err.items()},
            "grad_norm": {key: run[1]["grad_norm"] for key, run in runs.items()},
            "loss_track": {key: run[1]["loss_track"] for key, run in runs.items()},
            "loss_track_aux": {key: run[1]["loss_track_aux"] for key, run in runs.items()}}


def window_attn_backward_ms(dev) -> dict:
    """K7/K8's backward (the plain versions' VJP, recomputed from the saved
    qkv, bias and mask) at each Swin-L stage shape of a 1024x2048 image, bf16
    with the shift mask: median device ms of one backward by CUDA events,
    and its share of one step's backbone backward (blocks: 2 at stage 0,
    2 at stage 1, 18 at stage 2, 2 at stage 3)."""
    import torch

    from polyphonicformer_torch.models.swin import _shift_attn_mask, window_partition
    from polyphonicformer_torch.ops.cuda import window_attn

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ws, l, out = 7, 49, {}
    for stage, hp, wp, c, heads, blocks in ((0, 259, 518, 192, 6, 2), (1, 133, 259, 384, 12, 2),
                                            (2, 70, 133, 768, 24, 18), (3, 35, 70, 1536, 48, 2)):
        qkv = torch.randn((1, hp, wp, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((heads, l, l), generator=gen, device=dev) * 0.5
        mask = torch.from_numpy(_shift_attn_mask(hp, wp, ws, 3)).to(dev)
        q = (qkv if stage < 2 else window_partition(qkv, ws).contiguous()).requires_grad_(True)
        b = bias.requires_grad_(True)
        if stage < 2:
            y = window_attn.window_attention(q, b, mask, heads, ws)
        else:
            y = window_attn.window_attn_math(q, b, mask, heads)
        g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
        ms = _time_ms(lambda: torch.autograd.grad(y, (q, b), g, retain_graph=True), reps=5)
        out[f"stage{stage}"] = {"kernel": "window_attention" if stage < 2 else "window_attn_math",
                                "ms": ms, "blocks": blocks}
        del q, b, y, g
    out["per_step_ms"] = sum(v["ms"] * v["blocks"] for v in out.values())
    return out


def run_video_swin(dev) -> tuple:
    """Phase 7: one cold and one warm ``video_swinl`` bf16 video step at
    1024x2048, batch 1; the warm step's launches, time and memory."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    kernels = _kernels()
    cfg = preset("video_swinl")
    _check("video_swinl dtype", cfg.model.compute_dtype == "bfloat16", cfg.model.compute_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt, video=True)
    batch = synthetic_batch(cfg.model, 1, VIDEO_HW, two_frame=True, seed=0, max_instances=24,
                            device=dev)
    step_s, all_metrics = [], []
    for i in range(2):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    launches = _count_launches(kernels, SWIN_VIDEO_PER_STEP, 1, "swin video")
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(all_metrics):
        _finite_metrics(f"swin video step {i}", m)
    del state, opt, step, model
    torch.cuda.empty_cache()
    return launches, {
        "preset": "video_swinl", "hw": list(VIDEO_HW), "batch": 1, "dtype": "bfloat16",
        "max_instances": 24, "cold_step_s": step_s[0], "warm_step_ms": step_s[1] * 1e3,
        "peak_mem_gib": peak / 2 ** 30, "total_loss": [m["total_loss"] for m in all_metrics],
        "loss_track": [m["loss_track"] for m in all_metrics],
        "launches_per_step": SWIN_VIDEO_PER_STEP,
        "window_attn_backward": window_attn_backward_ms(dev)}


def run_video(dev):
    """Phase 7: the 2-frame video train step at full width, 1024x2048, B=1."""
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.structures import GTSample
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.ops.roi_align import masks_to_boxes_mad
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step
    from polyphonicformer_torch.train.video_losses import (gt_track_boxes, gt_track_masks,
                                                           track_losses)

    kernels = _kernels()
    cfg = preset("video_r50_1x")
    (h, w), steps = VIDEO_HW, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    m = state.model
    step = make_train_step(m, cfg, opt, video=True)
    batch = synthetic_batch(cfg.model, 1, (h, w), two_frame=True, seed=0, max_instances=24,
                            device=dev)
    frozen = m.backbone.conv1.weight.detach().clone()
    embed = m.track_head.fc_embed.weight.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.values():
        k.launches = 0
    step_s, all_metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        all_metrics.append({k: float(v) for k, v in metrics.items()})
    launches = _count_launches(kernels, PER_STEP, steps, "video")
    peak = torch.cuda.max_memory_allocated()
    for i, mt in enumerate(all_metrics):
        _finite_metrics(f"video step {i}", mt)
    _check("video frozen conv1", torch.equal(m.backbone.conv1.weight, frozen),
           "a frozen parameter moved")
    _check("video fc_embed", not torch.equal(m.track_head.fc_embed.weight, embed),
           "the track head's fc_embed did not move")
    _check("video step counter", int(state.step) == steps, f"{int(state.step)}")

    # one more step in stages, each closed by a synchronize (not counted)
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    t = time.perf_counter()
    opt.zero_grad()
    key_feats = m.extract_feat(batch.image)
    out = m.forward_heads(key_feats)
    t = mark("forward", t)
    asg = losses.assign(cfg.model, out, batch.gt)
    t = mark("assignment", t)
    total, _ = losses.losses_from(cfg.model, out, batch.gt, asg)
    t = mark("losses", t)
    with torch.no_grad():
        ref_feats = m.extract_feat(batch.ref_image)
    t = mark("ref_features", t)
    track = track_losses(m, cfg.model, batch, key_feats, ref_feats)
    t = mark("track_losses", t)
    (total + (track["loss_track"] + track["loss_track_aux"])).backward()
    t = mark("backward", t)
    opt.clip_grads()
    opt.step()
    mark("optimizer", t)
    del key_feats, out, asg, total, ref_feats, track
    opt.zero_grad()

    # the GT track boxes of both frames (2 x 64 slots) from the stride-4
    # marginals, bit-equal to the boxes of the materialised x4 upsample
    both = GTSample(*(torch.cat([a, r]) for a, r in zip(batch.gt, batch.ref_gt)))
    boxes_ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marginal = gt_track_boxes(both, (h, w))
    torch.cuda.synchronize()
    boxes_ms["marginal"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    full = gt_track_masks(both, (h, w))  # (2, 64, 1024, 2048) f32, 1 GiB
    materialised = masks_to_boxes_mad(full.flatten(0, 1)).reshape(marginal.shape)
    torch.cuda.synchronize()
    boxes_ms["materialised"] = (time.perf_counter() - t0) * 1e3
    del full
    n_valid = int(both.thing_valid.sum())
    _check("video gt boxes", torch.equal(marginal, materialised),
           f"{int((marginal != materialised).any(-1).sum())} boxes differ")
    _check("video gt boxes", n_valid >= 24 and bool((marginal[both.thing_valid][:, 2:] > 0).all()),
           f"{n_valid} valid slots")
    del state, opt, step, m, model, batch, both
    torch.cuda.empty_cache()

    info = {
        "preset": "video_r50_1x", "hw": [h, w], "batch": 1, "dtype": "float32",
        "max_instances": 24, "cold_step_s": step_s[0],
        "warm_steps_ms": [s * 1e3 for s in step_s[1:]],
        "median_warm_step_ms": statistics.median(s * 1e3 for s in step_s[1:]),
        "stages_ms": stages, "peak_mem_gib": peak / 2 ** 30,
        "total_loss": [mt["total_loss"] for mt in all_metrics],
        "loss_track": [mt["loss_track"] for mt in all_metrics],
        "loss_track_aux": [mt["loss_track_aux"] for mt in all_metrics],
        "grad_norm": [mt["grad_norm"] for mt in all_metrics],
        "launches": launches, "gt_boxes": {"valid_slots": n_valid, "bit_equal": True,
                                           "ms": boxes_ms},
        "small_reference": check_video_train_reference(dev)}
    swin_launches, info["swin"] = run_video_swin(dev)
    return {name: launches[name] + swin_launches[name] for name in launches}, info


EVAL_HW = (1024, 2048)  # phase 8's frames
EVAL_SEQS, EVAL_FRAMES = 2, 6  # sequences and frames a sequence of its split
EVAL_WORKERS = 4
LOADER_LOOPS = 4  # passes over the split when the loader alone is timed
DEMO_HW = (1000, 2000)  # not a multiple of 32: the general fusion branch
# the demo's image step (f32, general fusion): K1 in the rpn head and twice
# a stage, the three x2 upsamples, K4; the dense depth's non-integer resize
# is a matmul and the general branch launches no K3
DEMO_PER_IMAGE = {"mask_pool": 7, "upsample2": 3, "map_render": 1}


def _eval_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "work_dirs",
                        "chip_smoke_eval")


def _decode_ms(ds, dc) -> dict:
    """Mean ms a frame of each PNG decode and of the whole frame preparation
    (decode, panoptic remap, normalise, pad), serially in this process."""
    from polyphonicformer_torch.data.pipeline import make_test_input
    from polyphonicformer_torch.data.png import read_png

    times = {"image": [], "panoptic": [], "depth": [], "frame": []}
    for info in ds.images:
        for key, path in (("image", info["img"]), ("panoptic", info["ann"]),
                          ("depth", info["depth"])):
            t0 = time.perf_counter()
            read_png(path)
            times[key].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        make_test_input(ds.load_frame(info, segments=False), dc)
        times["frame"].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.mean(v) for k, v in times.items()}


def _loader_fps(ds, dc, padded_hw, gt_dir, dev) -> dict:
    """MPEvalLoader with EVAL_WORKERS workers (GT dumps included) over the
    split LOADER_LOOPS times: the steady frames/s, without the first round of
    workers (its frames and the time up to its last), and the seconds to the
    first frame."""
    import torch

    from polyphonicformer_torch.data.mp_loader import MPEvalLoader

    frames = ds.images * LOADER_LOOPS
    arrivals = []
    t_enter = time.perf_counter()
    with MPEvalLoader(ds, frames, dc, padded_hw, num_workers=EVAL_WORKERS,
                      gt_dir=gt_dir, device=dev) as loader:
        for _ in loader:
            arrivals.append(time.perf_counter())
        torch.cuda.synchronize()  # the last copy has landed
        t_end = time.perf_counter()
    w = EVAL_WORKERS
    return {"workers": w, "frames": len(frames), "first_frame_s": arrivals[0] - t_enter,
            "frames_per_s": (len(frames) - w) / (t_end - arrivals[w - 1])}


def _span_busy_ms(prof, span: str):
    """(device busy ms, wall ms) inside the host span ``span`` of one trace:
    the union of the card's kernels, copies and sets clipped to the span."""
    from torch.autograd import DeviceType

    from polyphonicformer_torch.tools.profile_paths import _device_events, busy_us

    hosts = [e for e in prof.events() if e.name == span and e.device_type == DeviceType.CPU]
    _check(f"profiler span {span}", len(hosts) == 1, f"{len(hosts)} spans")
    s, e = hosts[0].time_range.start, hosts[0].time_range.end
    inside = [(max(a, s), min(b, e)) for _, a, b in _device_events(prof) if b > s and a < e]
    _check(f"device events in {span}", len(inside) > 0, "the trace has none")
    return busy_us(inside) / 1e3, (e - s) / 1e3


def _dumps_equal(a_dir: str, b_dir: str, tag: str) -> int:
    import os

    import numpy as np

    from polyphonicformer_torch.evalutils.dvpq import list_frames

    n = 0
    for kind in ("pred", "gt"):
        a, b = list_frames(a_dir, kind), list_frames(b_dir, kind)
        _check(f"{tag} {kind} frames", [os.path.basename(p) for p in a]
               == [os.path.basename(p) for p in b] and len(a) == EVAL_SEQS * EVAL_FRAMES,
               f"{len(a)} vs {len(b)} dumps")
        for pa, pb in zip(a, b):
            fa, fb = np.load(pa), np.load(pb)
            for key in ("panseg", "depth"):
                bad = int((fa[key] != fb[key]).sum()) if fa[key].dtype == fb[key].dtype \
                    else -1
                _check(f"{tag} {kind} {os.path.basename(pa)} {key}", bad == 0,
                       f"{bad} values differ (-1: dtypes differ)")
            n += 1
    return n


def _gt_dumps_match_pngs(eval_dir: str, ds) -> None:
    """Each GT dump equals its frame's decoded PNGs."""
    import os

    import numpy as np

    for info in ds.images:
        frame = ds.load_frame(info, segments=False)
        f = np.load(os.path.join(eval_dir, "gt",
                                 f"{info['seq_id']:06d}_{info['img_id']:06d}.npz"))
        _check(f"gt dump {info['img_id']}", np.array_equal(f["panseg"], frame["pan"])
               and np.array_equal(f["depth"], np.round(frame["depth"] * 256).astype(np.uint16)),
               "differs from the decoded PNGs")


def run_eval(dev):
    """Phase 8: the evaluation CLIs at full width from PNGs on disk."""
    import math
    import os
    import pickle
    import shutil

    import numpy as np
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
    from polyphonicformer_torch.data.png import read_png, write_png
    from polyphonicformer_torch.data.synthetic_split import write_dvps_split
    from polyphonicformer_torch.evalutils.dvpq import list_frames
    from polyphonicformer_torch.tools import demo, eval_image, eval_video
    from polyphonicformer_torch.weights import to_jax_variables, to_numpy_state_dict

    dc = preset("video_r50_1x").data
    kernels = _kernels()
    work = _eval_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        root = os.path.join(work, "data")
        h, w = EVAL_HW
        t0 = time.perf_counter()
        write_dvps_split(root, "val", EVAL_SEQS, EVAL_FRAMES, h, w, seed=0, filter_type=4)
        write_s = time.perf_counter() - t0
        cfg, model, _ = _serving_model("video_r50_1x", dev)
        ckpt = os.path.join(work, "video_r50_1x_seed0.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump(to_jax_variables(to_numpy_state_dict(model), cfg), f)
        del model
        ds = CityscapesDVPSDataset(root, split="val", ref_sample_mode="img")
        n = len(ds.images)
        info = {"preset": "video_r50_1x", "hw": [h, w], "frames": n, "dtype": "bfloat16",
                "png_filter": "Paeth", "split_write_s": write_s, "decode_ms": _decode_ms(ds, dc),
                "loader": _loader_fps(ds, dc, (h, w), os.path.join(work, "loader_gt"), dev)}
        common = ["--data-root", root, "--checkpoint", ckpt, "--preset", "video_r50_1x",
                  "--bf16", "--workers", str(EVAL_WORKERS)]

        clip_dir, stream_dir = os.path.join(work, "clip"), os.path.join(work, "stream")
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = eval_video.main(common + ["--eval-dir", clip_dir, "--clip-len", str(EVAL_FRAMES),
                                        "--eval-stq", "--nproc", "8"])
        cli_s = time.perf_counter() - t0
        launches = _count_launches(kernels, PER_FRAME, n, "eval_video clip")
        results = out["results"]
        cells = [k for k in results if k not in ("average", "stq")]
        _check("dvpq cells", len(cells) == 16 and all(
            math.isfinite(v) for k in cells + ["average"] for v in results[k].values())
            and all(math.isfinite(v) for v in results["stq"].values()), json.dumps(results))

        from torch.profiler import ProfilerActivity, profile

        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stream = eval_video.main(common + ["--eval-dir", stream_dir, "--clip-len", "1",
                                               "--skip-aggregate"])
            torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        stream_launches = _count_launches(kernels, PER_FRAME, n, "eval_video streaming")
        launches = {k: launches[k] + stream_launches[k] for k in launches}
        busy_ms, span_ms = _span_busy_ms(prof, "eval_video.inference")
        compared = _dumps_equal(clip_dir, stream_dir, "clip vs streaming")
        _gt_dumps_match_pngs(clip_dir, ds)
        tracked = sum(int((np.load(p)["panseg"] % 10000 > 0).any())
                      for p in list_frames(clip_dir, "pred"))

        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        metrics = eval_image.main(["--data-root", root, "--checkpoint", ckpt, "--preset",
                                   "video_r50_1x", "--bf16"])
        image_s = time.perf_counter() - t0
        image_launches = _count_launches(kernels, PER_FRAME, n, "eval_image")
        _check("eval_image metrics", all(math.isfinite(v) for v in metrics.values()),
               json.dumps(metrics))

        img = read_png(ds.images[0]["img"])[:DEMO_HW[0], :DEMO_HW[1]]
        demo_in = os.path.join(work, "demo_in.png")
        write_png(demo_in, img)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        written = demo.main([demo_in, "--checkpoint", ckpt, "--preset", "video_r50_1x",
                             "--out-dir", os.path.join(work, "demo")])
        demo_s = time.perf_counter() - t0
        demo_launches = _count_launches(kernels, DEMO_PER_IMAGE, 1, "demo")
        outs = [read_png(p) for p in written]
        _check("demo outputs", len(outs) == 2 and all(
            o.shape == DEMO_HW + (3,) and o.dtype == np.uint8 for o in outs),
            f"{[o.shape for o in outs]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    inf, sinf = out["inference"], stream["inference"]
    info.update({
        # wall and frames/s from the loader's start to the last dump written;
        # steady: without the first round of workers
        "eval_video_clip": {"clip_len": EVAL_FRAMES, "frames_per_s": inf["frames_per_s"],
                            "steady_frames_per_s": inf["steady_frames_per_s"],
                            "first_frame_s": inf["first_frame_s"],
                            "inference_wall_s": inf["wall_s"],
                            "dump_write_ms": inf["dump_write_ms"],
                            "aggregate_s": out["aggregate_s"], "cli_wall_s": cli_s,
                            "dvpq_average": results["average"], "stq": results["stq"],
                            "frames_with_tracks": tracked},
        # one profiled run: its device busy time (the span also holds the
        # loader's shutdown, when the card runs nothing) over its own wall
        "eval_video_streaming": {
            "frames_per_s_profiled": sinf["frames_per_s"],
            "steady_frames_per_s_profiled": sinf["steady_frames_per_s"],
            "inference_wall_s_profiled": sinf["wall_s"], "cli_wall_s": stream_s,
            "span_ms": span_ms, "device_busy_ms": busy_ms,
            "device_busy_ms_a_frame": busy_ms / n,
            "busy_share_of_wall": busy_ms / 1e3 / sinf["wall_s"]},
        "dumps_bit_equal": compared,
        "eval_image": {"cli_wall_s": image_s, "frames_per_s": n / image_s,
                       "pq@inf": metrics["pq@inf"], "depth_abs_rel": metrics["depth_abs_rel"]},
        "demo": {"hw": list(DEMO_HW), "wall_s": demo_s, "launches": demo_launches},
        "launches": {k: launches[k] + image_launches[k] + demo_launches[k] for k in launches}})
    return info["launches"], info


if __name__ == "__main__":
    sys.exit(main())
