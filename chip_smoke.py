"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases: (1) the device; (2) the build of the hand-written kernels from
``polyphonicformer_torch/csrc``, and their tensor-core instructions in
``cuobjdump -sass`` (the bf16 K7/K8 and K1 must have some); (3) each
kernel against its plain PyTorch version at the shapes the serving and
training paths give it (the training CLI's batch-2 shapes among them), timed beside the plain version and, where one
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
times; (9) the training CLI from PNGs on disk: a 1024x2048 train split of 2
sequences x 6 frames and a 4-frame val split (Paeth rows), the seeded
``video_r50_1x`` weights as the JAX CLIs' checkpoint, then
``tools/train.py`` with the process loader (8 spawn workers), batch 2, 12
steps (the eval hook and a checkpoint at the end of each 6-step epoch), a
resumed run to step 14 that must start from step 12's parameters and
learning rate, and a profiled resumed run to step 24 (device busy share of
its steps), with a debug-size batch-2 video step on the card against the
same step on the card's plain route (its distance from the CPU's f64 step
reported), the loader alone at 8, 4 and 2 workers, one sample's
preparation by stage (``make_sample`` with its stages timed in place), the
checkpoint save and restore times and launches a step; (10) the model
options: the checkpoint converter (phase 8's seeded weights as an
mmcv-style ``.pth``, ``python -m polyphonicformer_torch.tools.convert_torch_ckpt``,
its variables bit-equal to phase 8's and ``tools/eval_video.py`` from them
over phase 8's first clip, its dumps bit-equal to phase 8's), SemKITTI-DVPS
(a 376x1241 split in its layout, ``tools/train.py --preset
video_r50_semkitti_1x`` with the process loader at batch 2 for 12 steps
with the eval hook, ``tools/eval_video.py`` over its val split with DVPQ
and STQ, a debug-width ``semantic_kitti`` batch-2 step from the train
loader on the card against the card's plain route), ``image_r50_2x`` on
``stdc1446`` with the ASPP head (3 train steps at 1024x2048 and a
debug-width step against the card's plain route and, with cuDNN off,
against the CPU's f64 step), an 8-frame 1024x2048 bf16
``video_r50_1x`` clip on ``stdc813``, and the flow-aligned FPN
(``UperNetAlignHead`` v1 and v2 on the card against the CPU, then at the
R50 FPN shapes of a 1024x2048 image).  Phase 3 also holds the kernels at
phase 10's SemKITTI training and evaluation shapes and the ASPP head's.
Phase 11 runs the tools: ``tools/export.py`` (``video_r50_1x`` bf16 frame mode
over 8 frames carrying the tracker state, the artifact loaded by
``load_serving`` in a fresh process that builds no model: bit-equal to the
eager ``video_frame_step`` and PER_FRAME launches a frame; the image mode and
the clip mode at clip_len 2 loaded in this process, bit-equal to their eager
steps; ``video_swinl`` frame mode, K8 4 and K7 20 launches a frame; export
seconds, artifact bytes and frames/s beside eager by the port's
``StepTimer``), ``tools/flops.py`` (``video_r50_1x``, ``video_swinl`` and
STDC813 at 1024x2048), ``tools/parity_check.py`` on phase 8's split with
phase 10's ``.pth`` (the measured values equal phase 8's, the gates at those
values exit 0, one moved beyond its tolerance exits 1) and the host solver
``ops/native.py::lsap_solve`` on phase 3's K5 problems (K5's assignments).
Every kernel entry is a ``poly::`` custom op, so phase 3 holds the ops.
Phases 4 to 11 each count the kernel launches of their own run.  Any failed phase raises,
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


def _pool_row(name, logits, feats) -> dict:
    """K1 against its plain version (rtol 1e-5 of sum |feat| over each
    mask), twice for equal bits, then timed.  Library: the cuBLAS
    product of the pre-thresholded mask in the features' dtype (the
    threshold itself is outside the timed call)."""
    import torch

    from polyphonicformer_torch.ops.cuda import mask_pool

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


def check_kernels(dev, gen) -> list[dict]:
    """Phase 3: every kernel of the serving path against its plain version."""
    import torch

    from torch.nn import functional as F

    from polyphonicformer_torch.ops.cuda import upsample2

    rows = []

    # K1 mask_pool: each stage (111 rows) and the rpn head (100 rows); feats
    # are the NCHW module tensors seen as (B, h, w, C) views, bf16 when
    # serving; f32 logits and feats in the f32 train step
    feats = torch.randn((1, 256, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
    feats_hwc = feats.permute(0, 2, 3, 1)
    for n, name in ((111, "mask_pool"), (100, "mask_pool_n100")):
        logits = torch.randn((1, n, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
        rows.append(_pool_row(name, logits, feats_hwc))
    logits = torch.randn((1, 111, 128, 256), generator=gen, device=dev)
    feats32 = torch.randn((1, 256, 128, 256), generator=gen, device=dev).permute(0, 2, 3, 1)
    rows.append(_pool_row("mask_pool_f32", logits, feats32))
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

    # K3 phase_fusion: 111 bf16 candidates at stride 4 -> 1024x2048; K4
    # map_render at 1024x2048
    rows.append(_fusion_row(dev, gen, 256, 512, "phase_fusion"))
    rows.append(_render_row(dev, gen, 1024, 2048, "map_render"))
    return rows


def _fusion_row(dev, gen, hs: int, ws: int, name: str) -> dict:
    """K3 on 111 bf16 candidates at stride 4 (hs, ws) -> x4, f32 scores,
    pruned to 64 full rows and not: pixels, marginals and areas bit-equal,
    depth within 1e-4 + 1e-5|d|; timed pruned."""
    import torch

    from polyphonicformer_torch.ops.cuda import phase_fusion

    probs = torch.sigmoid(torch.randn((111, hs, ws), generator=gen, device=dev) * 3)
    probs = probs.to(torch.bfloat16)
    scores = torch.rand((111,), generator=gen, device=dev)
    depth = (torch.rand((111, hs, ws), generator=gen, device=dev) * 70 + 1).to(torch.bfloat16)
    err = 0.0
    for n_full in (64, None):
        got = phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=n_full)
        torch.cuda.synchronize()
        want = phase_fusion.phase_fusion_plain(probs, scores, depth, 4, 4, n_full=n_full)
        tag = f"{name} n_full={n_full}"
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
    return dict(
        name=name, kernel="phase_fusion", route="cuda",
        source="polyphonicformer_torch/csrc/phase_fusion.cu",
        replaces="polyphonicformer_tpu/ops/pallas/phase_fusion.py:126", max_abs_err=err,
        library_ms=None, shape=f"(111, {hs}, {ws}) bf16 x4",
        **_bound(_nbytes(probs, scores, depth, *outs), ops, "f32_issue"),
        ms=_time_ms(lambda: phase_fusion.phase_fusion(probs, scores, depth, 4, 4, n_full=64)),
        plain_ms=_time_ms(lambda: phase_fusion.phase_fusion_plain(
            probs, scores, depth, 4, 4, n_full=64), reps=5))


def _render_row(dev, gen, h: int, w: int, name: str) -> dict:
    """K4 at (h, w): 64 table rows, pix in [0, 64] (64 is the sentinel);
    the four maps bit-equal."""
    import torch

    from polyphonicformer_torch.ops.cuda import map_render

    k = 64
    pix = torch.randint(0, k + 1, (h, w), generator=gen, device=dev, dtype=torch.int32)
    dep = torch.rand((h, w), generator=gen, device=dev) * 80
    db = torch.rand((h, w), generator=gen, device=dev) * 80
    labels = torch.randint(0, 19, (k,), generator=gen, device=dev, dtype=torch.int32)
    seg = torch.randint(0, k + 1, (k,), generator=gen, device=dev, dtype=torch.int32)
    keep = torch.rand((k,), generator=gen, device=dev) > 0.4
    trk = torch.randint(0, 1 << 20, (k,), generator=gen, device=dev, dtype=torch.int32) * keep
    args = (pix, dep, db, labels, seg, keep, trk, 19)
    got = map_render.render_maps(*args)
    torch.cuda.synchronize()
    want = map_render.render_maps_plain(*args)
    err = max(_exact(f"{name} {part}", g, w_)
              for part, g, w_ in zip(("semantic", "panoptic", "depth", "track"), got, want))
    return dict(
        name=name, kernel="map_render", route="cuda",
        source="polyphonicformer_torch/csrc/map_render.cu",
        replaces="polyphonicformer_tpu/ops/pallas/map_render.py:53", max_abs_err=err,
        library_ms=None, shape=f"({h}, {w})",
        **_bound(_nbytes(*(a for a in args if isinstance(a, torch.Tensor)), *got)),
        ms=_time_ms(lambda: map_render.render_maps(*args)),
        plain_ms=_time_ms(lambda: map_render.render_maps_plain(*args)))


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
    # K2b: gradients of the x2 upsamples of (1+3 stages x 111) mask logits
    # and of the 19 semantic logits, bit-equal
    rows = [_upsample_row(dev, gen, (444, 19), "upsample2_bwd", bwd=True)]
    rows.append(_lsa_row(dev, gen, 16, "lsa"))

    # K6 / K6b on the three refinement stages' mask volume and on the rpn
    # head's, the train step's two calls
    for shape, sfx in (((3, 111, 256, 512), ""), ((1, 100, 256, 512), "_n100")):
        rows += mask_loss_rows(dev, gen, shape, sfx)
    return rows


def check_train_cli_kernels(dev, gen) -> list[dict]:
    """Phase 3, the training CLI's shapes: phase 9's ``video_r50_1x`` step
    at batch TRAIN_BATCH and 1024x2048 stacks the batch's images along the
    leading axes.  K1 f32 on the batch's (B, 111) and (B, 100) logits over
    strided NHWC views of NCHW features; K2 and K2b on the x2 upsamples of
    the stacked masks (B x 4 x 111), stage depths (B x 3 x 111), semantic
    logits (B x 19) and dense depths (B); K5 on the step's 3 B problems; K6
    and K6b on the batch's stage (3 B, 111) and rpn (B, 100) volumes; each
    at the tolerance of its batch-1 row."""
    import torch

    b = TRAIN_BATCH
    rows = []
    feats = torch.randn((b, 256, 128, 256), generator=gen, device=dev).permute(0, 2, 3, 1)
    for n, sfx in ((111, ""), (100, "_n100")):
        logits = torch.randn((b, n, 128, 256), generator=gen, device=dev)
        rows.append(_pool_row(f"mask_pool_f32{sfx}_b{b}", logits, feats))
    del feats, logits
    ns = (4 * 111 * b, 3 * 111 * b, 19 * b, b)
    rows.append(_upsample_row(dev, gen, ns, f"upsample2_b{b}", bwd=False))
    rows.append(_upsample_row(dev, gen, ns, f"upsample2_bwd_b{b}", bwd=True))
    rows.append(_lsa_row(dev, gen, 3 * b, f"lsa_b{b}"))
    for shape, sfx in (((3 * b, 111, 256, 512), f"_b{b}"), ((b, 100, 256, 512), f"_n100_b{b}")):
        rows += mask_loss_rows(dev, gen, shape, sfx)
    return rows


def check_options_kernels(dev, gen) -> list[dict]:
    """Phase 3, phase 10's shapes, each at the tolerance of its serving or
    training row.  SemKITTI-DVPS training (``video_r50_semkitti_1x``, crop
    384x1248, batch SEMKITTI_BATCH): K1 f32 on (B, 111) and (B, 100) logits
    of 48x156 over strided NHWC views; K2 and K2b on the batch's x2
    upsamples of 48x156 maps; K5 on its 3 B problems with 16-24 valid rows
    (SemKITTI's ~20 things a frame); K6 and K6b on its (3 B, 111) and
    (B, 100) volumes of 96x312.  SemKITTI-DVPS evaluation, a 376x1241
    frame padded to 384x1248, bf16: K1 (1, 111), K2 on the stage masks, K3
    from 96x312 to 384x1248 and K4 at 376x1241.  The ASPP head at
    1024x2048: K2 and K2b on its 19 maps of 128x256."""
    import torch

    b = SEMKITTI_BATCH
    rows = []
    feats = torch.randn((b, 256, 48, 156), generator=gen, device=dev).permute(0, 2, 3, 1)
    for n, sfx in ((111, ""), (100, "_n100")):
        logits = torch.randn((b, n, 48, 156), generator=gen, device=dev)
        rows.append(_pool_row(f"mask_pool_f32{sfx}_semkitti", logits, feats))
    ns = (4 * 111 * b, 3 * 111 * b, 19 * b, b)
    for bwd, name in ((False, "upsample2_semkitti"), (True, "upsample2_bwd_semkitti")):
        rows.append(_upsample_row(dev, gen, ns, name, bwd=bwd, hw=(48, 156)))
    rows.append(_lsa_row(dev, gen, 3 * b, "lsa_semkitti", valid_rows=(16, 24)))
    for shape, sfx in (((3 * b, 111, 96, 312), "_semkitti"), ((b, 100, 96, 312), "_n100_semkitti")):
        rows += mask_loss_rows(dev, gen, shape, sfx)

    feats = torch.randn((1, 256, 48, 156), generator=gen, device=dev).to(torch.bfloat16)
    logits = torch.randn((1, 111, 48, 156), generator=gen, device=dev).to(torch.bfloat16)
    rows.append(_pool_row("mask_pool_semkitti_eval", logits, feats.permute(0, 2, 3, 1)))
    rows.append(_upsample_row(dev, gen, (111, 1), "upsample2_semkitti_eval", bwd=False,
                              hw=(48, 156)))
    rows.append(_fusion_row(dev, gen, 96, 312, "phase_fusion_semkitti"))
    rows.append(_render_row(dev, gen, 376, 1241, "map_render_semkitti"))

    for bwd, name in ((False, "upsample2_aspp"), (True, "upsample2_bwd_aspp")):
        rows.append(_upsample_row(dev, gen, (19,), name, bwd=bwd))
    return rows


def _upsample_row(dev, gen, ns, name: str, bwd: bool, hw=(128, 256)) -> dict:
    """K2 (x2 of (n, h, w)) or K2b (its (n, 2h, 2w) gradient) for each n of
    ``ns``, bit-equal to the plain version; timed at the first n."""
    import torch

    from torch.nn import functional as F

    from polyphonicformer_torch.ops.cuda import upsample2

    h, w = hw
    err, timed = 0.0, None
    for n in ns:
        if bwd:
            x = torch.randn((n, 2 * h, 2 * w), generator=gen, device=dev)
            fns = (lambda x=x: upsample2._upsample_int_bwd_cuda(x, 2, 2),
                   lambda x=x: upsample2.upsample_int_bwd_plain(x, 2, 2),
                   lambda x=x, n=n: torch.ops.aten.upsample_bilinear2d_backward(
                       x[:, None], [2 * h, 2 * w], [n, 1, h, w], False, 2.0, 2.0))
        else:
            x = torch.randn((n, h, w), generator=gen, device=dev)
            fns = (lambda x=x: upsample2.upsample_int(x, 2),
                   lambda x=x: upsample2.upsample_int_plain(x, 2, 2),
                   lambda x=x: F.interpolate(x[:, None], scale_factor=2, mode="bilinear",
                                             align_corners=False))
        got = fns[0]()
        torch.cuda.synchronize()
        err = max(err, _exact(f"{name} n={n}", got, fns[1]()))
        if timed is None:
            timed = (x, got, fns)
    x, got, (kernel, plain, library) = timed
    return dict(
        name=name, kernel="upsample2_bwd" if bwd else "upsample2", route="cuda",
        source="polyphonicformer_torch/csrc/upsample.cu",
        replaces=f"polyphonicformer_tpu/ops/pallas/upsample2.py:{172 if bwd else 154}",
        max_abs_err=err, ms=_time_ms(kernel), plain_ms=_time_ms(plain),
        library_ms=_time_ms(library),
        shape=f"{tuple(x.shape)} f32 x2{' gradient' if bwd else ''}"
              + (f", also n in {list(ns[1:])}" if len(ns) > 1 else ""),
        **_bound(_nbytes(x, got)))


def _lsa_row(dev, gen, problems: int, name: str, valid_rows=(12, 40)) -> dict:
    """K5 on ``problems`` seeded (64 GT x 100 predictions) problems,
    ``valid_rows`` (12-40) valid rows each, some invalid rows between valid ones; raw costs,
    handed over as the assignment hands them: a transposed view of
    (problems, 100, 64).  Equal assignments to the plain solver and on a
    second launch; its latency bound is the longest problem's Dijkstra
    steps x one warp-wide argmin step (tools/kernel_probe.py)."""
    import torch

    from polyphonicformer_torch.ops.cuda import lsa
    from polyphonicformer_torch.ops.hungarian import match_gt_to_preds_batched
    from polyphonicformer_torch.tools import kernel_probe

    costs = torch.randn((problems, 64, 100), generator=gen, device=dev) * 2
    counts = torch.randint(valid_rows[0], valid_rows[1] + 1, (problems,), generator=gen,
                           device=dev)
    valid = torch.arange(64, device=dev)[None] < counts[:, None]
    holes = torch.rand((problems, 64), generator=gen, device=dev) < 0.15
    valid = valid & ~(holes & (torch.arange(64, device=dev) < 10))
    raw = costs.transpose(1, 2).contiguous().transpose(1, 2)
    got = match_gt_to_preds_batched(raw, valid)
    torch.cuda.synchronize()
    steps = []
    want = lsa.solve_lsa_plain(raw.cpu(), valid.cpu(), steps)
    _check(name, torch.equal(got.cpu(), want), "assignments differ from the plain solver")
    _check(name, torch.equal(lsa.solve_lsa(raw, valid), got), "two launches differ")
    step_us = kernel_probe.warp_step_us(dev, problems, 100)
    ms = _time_ms(lambda: lsa.solve_lsa(raw, valid))
    return dict(
        name=name, kernel="lsa", route="cuda", source="polyphonicformer_torch/csrc/lsa.cu",
        replaces="polyphonicformer_tpu/ops/pallas/lsa.py:133", max_abs_err=0.0, ms=ms,
        plain_ms=_time_ms(lambda: lsa.solve_lsa_plain(raw, valid), reps=3),
        library_ms=None, shape=f"{problems} problems (64, 100) f32, "
                               f"{valid_rows[0]}-{valid_rows[1]} valid rows",
        **_bound(_nbytes(raw, valid, got)),
        dijkstra_steps_longest=max(steps), warp_argmin_step_us=step_us,
        latency_bound_us=max(steps) * step_us,
        latency_bound_share=max(steps) * step_us / (ms * 1e3))


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
    import shutil

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
    rows = (check_kernels(dev, gen) + check_train_kernels(dev, gen)
            + check_train_cli_kernels(dev, gen) + check_options_kernels(dev, gen)
            + check_swin_kernels(dev, gen))
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
    try:
        train_cli_launches, train_cli_info = run_train_cli(dev)
        print(f"[9 train_cli] {json.dumps(train_cli_info)}", flush=True)
        options_launches, _ = run_options(dev)
        tools_launches, _ = run_tools(dev)
    finally:
        shutil.rmtree(_eval_dir(), ignore_errors=True)
    for r in rows:
        kernel = r.pop("kernel", r["name"])  # rows at several shapes share a kernel
        by_path = {"serve": serve_launches.get(kernel, 0),
                   "train": train_launches.get(kernel, 0),
                   "swin": swin_launches.get(kernel, 0),
                   "video": video_launches.get(kernel, 0),
                   "eval": eval_launches.get(kernel, 0),
                   "train_cli": train_cli_launches.get(kernel, 0),
                   "options": options_launches.get(kernel, 0),
                   "tools": tools_launches.get(kernel, 0)}
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


def _serve_clip(tag: str, model, cfg, frames, per_frame: dict, dev,
                require_tracks: bool = True):
    """An 8-frame clip through ``make_clip_step`` (bf16), counted and
    checked (with ``require_tracks``, some detection must reach the
    tracker); then a warm pass of the clip and the same frames one by one
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
    _check(f"{tag} detections", not require_tracks or (
        int(state.num_tracklets) > 0 and bool((out.track_map > 0).any())),
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


def _serving_model(preset: str, dev, **replacements):
    """The preset's model (with ``replacements``) on the card, weights drawn
    from seed 0."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.models import build_model

    cfg = model_preset(preset, **replacements)
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


def check_video_train_reference(dev, batch: int = 1, against: str = "f64") -> dict:
    """One debug_tiny_video step (2 frames, 64x128, ``batch`` clips of
    ``synthetic_batch``) through :func:`check_step_reference`."""
    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch

    cfg = preset("debug_tiny_video")
    return check_step_reference(
        dev, cfg, lambda device: synthetic_batch(cfg.model, batch, (64, 128), two_frame=True,
                                                 seed=0, max_instances=6, device=device),
        against, video=True)


def check_step_reference(dev, cfg, make_batch, against: str = "f64", video: bool = True,
                         per_step=None, cudnn_witness: bool = False) -> dict:
    """One train step of the debug-width ``cfg`` on the batch
    ``make_batch(device)`` (float images) on the same weights three ways:
    on the card in f32 (kernels), on the CPU in f32 and on the CPU in f64
    (parameters, images and activations in f64 except where the model
    casts to f32).  Checks: the card step launches exactly ``per_step``
    (PER_STEP); assignments equal; every loss and the grad_norm within
    VIDEO_RTOL of the run ``against``: the f64 step, or ``"card_plain"``, a
    fourth run, the card's f32 step with the plain versions of K1, K2, K2b,
    K5, K6 and K6b in their place.  Phase 9 holds its batch-2 step to the
    plain route: at batch 2 both card steps lie ~3e-4 from f64 in stage
    2's losses, the plain route as far as the kernels, so that distance is
    the card's f32 arithmetic outside the kernels (stage 2 reads a hard
    mask of stage 1's logits, which f32 rounding can move across the
    threshold).  With ``cudnn_witness`` a fifth run, the card's step with
    cuDNN off (PyTorch's own convolutions, the kernels in place), is held
    to the f64 step at VIDEO_RTOL: on STDC the card's step with cuDNN lies
    ~6e-4 from f64 in grad_norm, its plain route as far, and without cuDNN
    ~4e-7 (measured on an H100 80GB HBM3), so that distance is cuDNN's f32
    convolutions.  Every run's distance from f64 is reported."""
    import torch

    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.train import losses
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    per_step = PER_STEP if per_step is None else per_step
    cpu = build_model(cfg.model, "cpu", generator=torch.Generator().manual_seed(0))
    kernels = _kernels()

    def step(device, dtype=torch.float32):
        model = build_model(cfg.model, device, state_dict=cpu.state_dict())
        state, opt = create_train_state(model, cfg, None, device=device)
        state.model.to(dtype)
        for st in opt.adamw.state.values():
            st["exp_avg"], st["exp_avg_sq"] = st["exp_avg"].to(dtype), st["exp_avg_sq"].to(dtype)
        clips = make_batch(device)
        clips = clips._replace(image=clips.image.to(dtype))
        if video:
            clips = clips._replace(ref_image=clips.ref_image.to(dtype))
        with torch.no_grad():
            asg = losses.assign(cfg.model, state.model(clips.image), clips.gt)
        for k in kernels.values():
            k.launches = 0
        _, metrics = make_train_step(state.model, cfg, opt, video=video)(state, clips)
        launches = {name: k.launches for name, k in kernels.items()}
        return [a.gt2pred.cpu() for a in asg.assigns], {k: float(v) for k, v in metrics.items()}, \
            launches

    runs = {"f64": step("cpu", torch.float64), "cpu_f32": step("cpu"), "card": step(dev)}
    if against == "card_plain":
        route = _plain_route()
        real = [getattr(mod, name) for mod, name, _ in route]
        for mod, name, plain in route:
            setattr(mod, name, plain)
        try:
            runs["card_plain"] = step(dev)
        finally:
            for (mod, name, _), fn in zip(route, real):
                setattr(mod, name, fn)
    if cudnn_witness:
        torch.backends.cudnn.enabled = False
        try:
            runs["card_no_cudnn"] = step(dev)
        finally:
            torch.backends.cudnn.enabled = True
    _check("step reference launches",
           all(runs["card"][2][k] == per_step.get(k, 0) for k in kernels),
           f"{runs['card'][2]}")
    ref_asg, ref_metrics, _ = runs["f64"]
    _check("step reference assignments", all(
        torch.equal(a, b) for run in runs.values() for a, b in zip(ref_asg, run[0])),
        "an f32 step's assignments differ from the f64 step's")
    err = {key: {k: abs(run[1][k] - v) / max(abs(v), 1e-6) for k, v in ref_metrics.items()}
           for key, run in runs.items() if key != "f64"}
    held = runs[against][1]
    held_err = {k: abs(runs["card"][1][k] - v) / max(abs(v), 1e-6) for k, v in held.items()}
    for k, v in held_err.items():
        _check(f"step reference {k}", v <= VIDEO_RTOL,
               f"{runs['card'][1][k]} on the card, {held[k]} in the {against} run")
    if cudnn_witness:
        for k, v in err["card_no_cudnn"].items():
            _check(f"step reference {k} without cuDNN", v <= VIDEO_RTOL,
                   f"{runs['card_no_cudnn'][1][k]} on the card, {ref_metrics[k]} in f64")
    out = {"tolerance": VIDEO_RTOL, "batch": int(ref_asg[0].shape[0]),
           "held_to": against, "max_metric_rel_err_to_held": max(held_err.values()),
           "max_metric_rel_err_to_f64": {key: max(e.values()) for key, e in err.items()},
           "worst_metric": {key: max(e, key=e.get) for key, e in err.items()},
           "grad_norm": {key: run[1]["grad_norm"] for key, run in runs.items()}}
    for name in ("loss_track", "loss_track_aux", "loss_aspp_semseg"):
        if name in ref_metrics:
            out[name] = {key: run[1][name] for key, run in runs.items()}
    return out


def _plain_route() -> list:
    """(module, function, plain version) of each launch function of the
    train step's kernels K1, K2, K2b, K5, K6 and K6b: set in place, the
    card runs the plain versions (K5's on the CPU)."""
    from polyphonicformer_torch.ops.cuda import lsa, mask_loss, mask_pool, upsample2

    return [(mask_pool, "_mask_pool_cuda", mask_pool.mask_pool_plain),
            (upsample2, "_upsample_int_cuda", upsample2.upsample_int_plain),
            (upsample2, "_upsample_int_bwd_cuda", upsample2.upsample_int_bwd_plain),
            (lsa, "_solve_lsa_cuda",
             lambda c, v: lsa.solve_lsa_plain(c.cpu(), v.cpu()).to(c.device)),
            (mask_loss, "_stats_cuda", mask_loss.mask_loss_stats_plain),
            (mask_loss, "_grad_cuda", mask_loss.mask_loss_grad_plain)]


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
    """Phase 8: the evaluation CLIs at full width from PNGs on disk.  Its
    directory (``_eval_dir()``) stays for phase 10."""
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
                                   "video_r50_1x", "--bf16", "--out",
                                   os.path.join(work, "eval_image.json")])
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
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    # the split, the checkpoint, the clip dumps and the metrics stay for
    # phases 10 and 11; main removes them

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


TRAIN_HW = (1024, 2048)  # phase 9's frames
TRAIN_SEQS, TRAIN_FRAMES = 2, 6  # its train split
TRAIN_VAL_FRAMES = 4  # its val split, one sequence: the eval hook's frames
TRAIN_BATCH = 2  # the reference's video batch a GPU (poly_r50_cityscapes_1x.py)
TRAIN_STEPS, RESUME_STEPS, PROFILE_STEPS = 12, 14, 24  # --max-steps of the three runs
PROFILE_AFTER = 5  # steps of the profiled run before its trace starts
TRAIN_LOG_INTERVAL = 4
LOADER_BATCHES = 16  # batches of the loader alone
# the loader alone at the CLI's 8 workers and at fewer: where its rate falls
# below the step's
LOADER_WORKERS = (8, 4, 2)
PREP_CLIPS = 4  # 2-frame clips whose preparation is timed in one process
# the eval hook's f32 image step a frame: K1 in the rpn head and twice a
# stage, the three x2 upsamples and the x4 dense depth, K4; the f32 fusion
# merges phases without K3
EVAL_F32_PER_FRAME = {"mask_pool": 7, "upsample2": 4, "map_render": 1}


def _train_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "work_dirs",
                        "chip_smoke_train")


def _train_prep_ms(ds, cfg) -> dict:
    """Mean ms a 2-frame sample of the loader's own ``make_sample`` in this
    process, over PREP_CLIPS accepted clips, split by timing its stages in
    place: decode (``load_frame``, the frames' PNGs and segments), the image
    resize (``resize_linear_u8``, native), the mask and depth resizes
    (``resize_nearest``, numpy gathers), GT prep (``frame_to_sample``) and
    the rest (flip, crop, the shared-id check, the draws).  The work of
    rejected clips is counted in the accepted ones'."""
    import random

    from polyphonicformer_torch.data import loader as L
    from polyphonicformer_torch.data import pipeline as P

    spent = {"decode": 0.0, "resize_image": 0.0, "resize_nearest": 0.0, "gt_prep": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    stages = {"resize_image": "resize_linear_u8", "resize_nearest": "resize_nearest",
              "gt_prep": "frame_to_sample"}
    real = {name: getattr(P, name) for name in stages.values()}
    for key, name in stages.items():
        setattr(P, name, timed(key, real[name]))
    ds.load_frame = timed("decode", ds.load_frame)  # an instance attribute, deleted below
    rng, pipeline = random.Random(0), P.TrainPipeline(cfg.data, cfg.model)
    try:
        t0 = time.perf_counter()
        for _ in range(PREP_CLIPS):
            L.make_sample(ds, pipeline, True, rng)
        total = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(P, name, fn)
        del ds.load_frame
    out = {k: v * 1e3 / PREP_CLIPS for k, v in spent.items()}
    out["rest"] = total * 1e3 / PREP_CLIPS - sum(out.values())
    out["sample"] = total * 1e3 / PREP_CLIPS
    return out


def _train_loader_rate(ds, cfg, dev, workers: int) -> dict:
    """MPTrainLoader alone over the split with ``workers`` processes:
    LOADER_BATCHES batches, the steady samples/s without the first round of
    workers (its samples and the time up to its last), and the seconds to
    the first batch."""
    import torch

    from polyphonicformer_torch.data.mp_loader import MPTrainLoader

    loader = MPTrainLoader(ds, cfg.data, cfg.model, seed=0, num_workers=workers, device=dev)
    arrivals = []
    t0 = time.perf_counter()
    it = iter(loader)
    try:
        for _ in range(LOADER_BATCHES):
            next(it)
            arrivals.append(time.perf_counter())
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        loader.stop()
    w, b = loader.num_workers, cfg.data.batch_size
    first = -(-w // b)  # batches of the first round
    return {"workers": w, "batch": b, "batches": LOADER_BATCHES,
            "first_batch_s": arrivals[0] - t0,
            "samples_per_s": (LOADER_BATCHES - first) * b / (t_end - arrivals[first - 1])}


def _window_busy_ms(prof, span: str):
    """(device busy ms, wall ms, spans) of the window from the start of the
    first host span ``span`` in the trace to the end of the last but one
    (the last is cut by the profiler's stop): the union of the card's
    kernels, copies and sets clipped to that window."""
    from torch.autograd import DeviceType

    from polyphonicformer_torch.tools.profile_paths import _device_events, busy_us

    hosts = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == span and e.device_type == DeviceType.CPU)
    _check(f"profiler spans {span}", len(hosts) >= 3, f"{len(hosts)} spans")
    s, e = hosts[0][0], hosts[-2][1]
    inside = [(max(a, s), min(b, e)) for _, a, b in _device_events(prof) if b > s and a < e]
    _check(f"device events in {span}", len(inside) > 0, "the trace has none")
    return busy_us(inside) / 1e3, (e - s) / 1e3, len(hosts) - 1


def _bare_step_ms(cfg, ckpt: str, dev) -> dict:
    """The CLI's train step alone: ``make_train_step(video=True)`` at batch
    TRAIN_BATCH on one seeded synthetic 2-frame batch (24 things), 4 steps
    closed by a synchronize each; the median of the last 3."""
    import torch

    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.tools._cli import load_model
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    h, w = TRAIN_HW
    state, opt = create_train_state(load_model(ckpt, cfg.model, dev), cfg, None,
                                    steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt, video=True)
    batch = synthetic_batch(cfg.model, TRAIN_BATCH, (h, w), two_frame=True, seed=0,
                            max_instances=24, device=dev)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _finite_metrics("bare train_cli step", {k: float(v) for k, v in metrics.items()})
    return {"warm_steps_ms": walls[1:], "median_warm_step_ms": statistics.median(walls[1:])}


def _metric_lines(path: str) -> list:
    import math

    with open(path) as f:
        lines = [json.loads(line) for line in f]
    bad = [(r["step"], k) for r in lines for k, v in r.items() if not math.isfinite(v)]
    _check("train metrics finite", not bad, f"non-finite {bad}")
    _check("train metrics guard", all(r["skipped_nonfinite"] == 0.0 for r in lines),
           "a step was skipped")
    return lines


def run_train_cli(dev):
    """Phase 9: the training CLI at full width from PNGs on disk."""
    import math
    import os
    import pickle
    import shutil

    import torch

    from polyphonicformer_torch.configs import apply_overrides, parse_overrides, preset
    from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
    from polyphonicformer_torch.data.synthetic_split import write_dvps_split
    from polyphonicformer_torch.evalutils import runner
    from polyphonicformer_torch.ops import native
    from polyphonicformer_torch.tools import train
    from polyphonicformer_torch.train import checkpoint
    from polyphonicformer_torch.weights import to_jax_variables, to_numpy_state_dict

    kernels = _kernels()
    work = _train_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sets = [f"data.batch_size={TRAIN_BATCH}", "data.repeat_times=1",
            f"schedule.log_interval={TRAIN_LOG_INTERVAL}"]
    cfg = apply_overrides(preset("video_r50_1x"), parse_overrides(sets))
    eval_runs, restores = [], []
    real_eval, real_restore = runner.evaluate_frames, checkpoint.restore_state

    def counted_eval(*a, **kw):  # the hook's launches, apart from the steps'
        before = {n: k.launches for n, k in kernels.items()}
        out = real_eval(*a, **kw)
        eval_runs.append({n: k.launches - before[n] for n, k in kernels.items()})
        return out

    def checked_restore(mgr, state, opt, step=None):
        state = real_restore(mgr, state, opt, step)
        saved = torch.load(mgr.file(int(state.step)), map_location="cpu", weights_only=True)
        diff = max(float((p.detach().cpu() - saved["model"][n]).abs().max())
                   for n, p in state.model.named_parameters())
        restores.append({"step": int(state.step), "max_param_diff": diff,
                         "last_epoch": opt.scheduler.last_epoch,
                         "lr": [g["lr"] for g in opt.adamw.param_groups],
                         "saved_lr": [g["lr"] for g in saved["optimizer"]["adamw"]["param_groups"]]})
        return state

    runner.evaluate_frames, checkpoint.restore_state = counted_eval, checked_restore
    try:
        root = os.path.join(work, "data")
        h, w = TRAIN_HW
        t0 = time.perf_counter()
        write_dvps_split(root, "train", TRAIN_SEQS, TRAIN_FRAMES, h, w, seed=0, filter_type=4)
        write_dvps_split(root, "val", 1, TRAIN_VAL_FRAMES, h, w, seed=1, filter_type=4)
        write_s = time.perf_counter() - t0
        mcfg, model, _ = _serving_model("video_r50_1x", dev)
        ckpt = os.path.join(work, "video_r50_1x_seed0.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump(to_jax_variables(to_numpy_state_dict(model), mcfg), f)
        del model
        native.load()  # raises if the native resizes do not build
        ds = CityscapesDVPSDataset(root, split="train", ref_sample_mode="random",
                                   ref_seq_index=cfg.data.ref_seq_index)
        info = {"preset": "video_r50_1x", "hw": [h, w], "batch": TRAIN_BATCH,
                "train_frames": len(ds), "val_frames": TRAIN_VAL_FRAMES, "png_filter": "Paeth",
                "split_write_s": write_s,
                # the CLI's batch through every kernel of its step, small
                "small_reference": check_video_train_reference(dev, TRAIN_BATCH, "card_plain"),
                "prep_ms": _train_prep_ms(ds, cfg),
                "loader": [_train_loader_rate(ds, cfg, dev, n) for n in LOADER_WORKERS]}
        run_dir = os.path.join(work, "run")
        common = ["--preset", "video_r50_1x", "--data-root", root, "--work-dir", run_dir,
                  "--load-from", ckpt, "--loader", "process", "--set", *sets]

        def cli(steps: int, *extra):
            for k in kernels.values():
                k.launches = 0
            eval_runs.clear()
            t0 = time.perf_counter()
            out = train.main(common + ["--max-steps", str(steps), *extra])
            torch.cuda.synchronize()
            out["cli_wall_s"] = time.perf_counter() - t0
            evals = {n: sum(r[n] for r in eval_runs) for n in kernels}
            n_steps = out["end_step"] - out["start_step"]
            steps_only = {n: k.launches - evals[n] for n, k in kernels.items()}
            for n, v in steps_only.items():
                _check(f"train_cli launches {n}", v == PER_STEP.get(n, 0) * n_steps,
                       f"{v} launches in {n_steps} steps, expected {PER_STEP.get(n, 0)} a step")
            n_frames = len(out["evals"]) * TRAIN_VAL_FRAMES
            for n, v in evals.items():
                _check(f"train_cli eval launches {n}", v == EVAL_F32_PER_FRAME.get(n, 0) * n_frames,
                       f"{v} launches in {n_frames} eval frames")
            out["launches"] = {n: k.launches for n, k in kernels.items()}
            out["step_launches"] = steps_only
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        main_run = cli(TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        lines = _metric_lines(main_run["metrics_path"])
        size = os.path.getsize(main_run["saves"][-1]["path"])
        spe = main_run["steps_per_epoch"]
        _check("train_cli steps", (main_run["start_step"], main_run["end_step"], spe)
               == (0, TRAIN_STEPS, len(ds) // TRAIN_BATCH), json.dumps(
                   {k: main_run[k] for k in ("start_step", "end_step", "steps_per_epoch")}))
        _check("train_cli log lines", [r["step"] for r in lines]
               == list(range(TRAIN_LOG_INTERVAL, TRAIN_STEPS + 1, TRAIN_LOG_INTERVAL)),
               f"{[r['step'] for r in lines]}")
        _check("train_cli saves", [s["step"] for s in main_run["saves"]]
               == list(range(spe, TRAIN_STEPS + 1, spe)), json.dumps(main_run["saves"]))
        _check("train_cli evals", [e["step"] for e in main_run["evals"]]
               == list(range(spe, TRAIN_STEPS + 1, spe)) and all(
                   math.isfinite(v) for e in main_run["evals"] for v in e["metrics"].values()),
               json.dumps(main_run["evals"]))

        resume = cli(RESUME_STEPS, "--resume", "--eval-every-epochs", "0")
        _check("train_cli resume", (resume["start_step"], resume["end_step"])
               == (TRAIN_STEPS, RESUME_STEPS) and len(restores) == 1
               and restores[0]["step"] == TRAIN_STEPS and restores[0]["max_param_diff"] == 0.0
               and restores[0]["last_epoch"] == TRAIN_STEPS
               and restores[0]["lr"] == restores[0]["saved_lr"], json.dumps(restores))
        _metric_lines(resume["metrics_path"])

        # a trace of steps PROFILE_AFTER + 1 on of a resumed run, after its
        # workers' first round: the profiler starts and stops from the step
        from torch.profiler import ProfilerActivity, profile

        from polyphonicformer_torch.train import step as step_mod

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        real_make = step_mod.make_train_step

        def traced_make(*a, **kw):
            fn, calls = real_make(*a, **kw), []

            def traced(state, batch):
                out = fn(state, batch)
                calls.append(1)
                if len(calls) == PROFILE_AFTER:
                    prof.start()
                elif len(calls) == PROFILE_STEPS - RESUME_STEPS:
                    prof.stop()
                return out
            return traced

        step_mod.make_train_step = traced_make
        try:
            profiled = cli(PROFILE_STEPS, "--resume", "--eval-every-epochs", "0")
        finally:
            step_mod.make_train_step = real_make
        busy_ms, window_ms, traced_steps = _window_busy_ms(prof, "train.step")
        bare = _bare_step_ms(cfg, ckpt, dev)
        kept = [s for s in range(RESUME_STEPS + 1, PROFILE_STEPS + 1)
                if s % spe == 0 or s == PROFILE_STEPS][-2:]
        _check("train_cli checkpoints kept", checkpoint.make_manager(run_dir).steps() == kept,
               f"{checkpoint.make_manager(run_dir).steps()}, expected {kept}")
    finally:
        runner.evaluate_frames, checkpoint.restore_state = real_eval, real_restore
        shutil.rmtree(work, ignore_errors=True)

    walls = [s * 1e3 for s in main_run["step_wall_s"][1:]]
    in_loader = [s * 1e3 for s in main_run["loader_s"][1:]]
    waits = [s * 1e3 for s in main_run["sample_wait_s"][1:]]
    last = slice(-TRAIN_LOG_INTERVAL, None)  # the steps of the last log interval
    steady = lines[-1]
    info.update({
        "cli_wall_s": main_run["cli_wall_s"],
        # the last log interval: no save or evaluation inside it
        "steady_samples_per_s": steady["samples_per_sec"],
        "steady_steps_per_s": steady["samples_per_sec"] / TRAIN_BATCH,
        "samples_per_s_by_interval": [r["samples_per_sec"] for r in lines],
        # host wall of a step inside the CLI (loader wait, transfer, the
        # queued step), the first left out
        "median_step_wall_ms": statistics.median(walls), "step_wall_ms": walls,
        # the part of it in the loader (waiting for samples, the copy into
        # pinned staging after its CUDA event, the transfer), and of that the
        # wait for samples
        "loader_ms": in_loader, "sample_wait_ms": waits,
        "steady_median_step_wall_ms": statistics.median(walls[last]),
        "steady_median_loader_ms": statistics.median(in_loader[last]),
        "steady_median_sample_wait_ms": statistics.median(waits[last]),
        "total_loss": [r["total_loss"] for r in lines],
        "peak_mem_gib": peak / 2 ** 30,
        "checkpoint": {"save_s": [s["s"] for s in main_run["saves"]],
                       "restore_s": resume["restore_s"], "file_mib": size / 2 ** 20},
        "eval_hook": [{"step": e["step"], "s": e["s"], "pq@inf": e["metrics"]["pq@inf"],
                       "depth_abs_rel": e["metrics"]["depth_abs_rel"]}
                      for e in main_run["evals"]],
        "resume": {"start_step": resume["start_step"], "end_step": resume["end_step"],
                   "restored": restores[0], "cli_wall_s": resume["cli_wall_s"]},
        "bare_step": bare,
        "profiled": {"steps": traced_steps, "window_ms": window_ms,
                     "device_busy_ms": busy_ms, "busy_share": busy_ms / window_ms},
        "launches_a_step": {n: main_run["step_launches"][n] / TRAIN_STEPS for n in PER_STEP},
        "launches": {n: main_run["launches"][n] + resume["launches"][n]
                     + profiled["launches"][n] for n in kernels}})
    return info["launches"], info


SEMKITTI_HW = (376, 1241)  # phase 10's SemKITTI-DVPS frames, the real size
SEMKITTI_SEQS, SEMKITTI_FRAMES = 2, 6  # its train split
SEMKITTI_VAL_SEQS, SEMKITTI_VAL_FRAMES = 2, 4  # its val split (eval hook and eval_video)
SEMKITTI_BATCH = 2  # video_r50_1x's batch a GPU, as phase 9
SEMKITTI_STEPS = 12  # the CLI's --max-steps: evaluations and saves at 6 and 12
SEMKITTI_SMALL_HW, SEMKITTI_SMALL_CROP = (94, 310), (96, 320)  # the debug step's, / 4
# a SemKITTI frame, padded to 384x1248, fuses at its own 376x1241, which is
# no multiple of the 96x312 stride-4 maps (the JAX package's general
# branch): K1 in the rpn head and twice a stage, the three x2 upsamples, K4;
# no K3, and the dense depth's resize is a matmul; in clip mode and in the
# eval hook's f32 image step alike
SEMKITTI_EVAL_PER_FRAME = {"mask_pool": 7, "upsample2": 3, "map_render": 1}
# the ASPP head adds one x2 upsample of its 19 maps, forward and backward
ASPP_PER_STEP = {**PER_STEP, "upsample2": PER_STEP["upsample2"] + 1,
                 "upsample2_bwd": PER_STEP["upsample2_bwd"] + 1}
OPTIONS_HW = (1024, 2048)  # the STDC + ASPP steps' and the STDC clip's frames
OPTIONS_STEPS = 3  # STDC + ASPP train steps
OPTIONS_SETS = ["model.backbone=stdc1446", "model.with_semantic_aspp=true"]
FPN_RTOL = 1e-4  # the aligned FPN on the card against the CPU, of max |cpu|


def _semkitti_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "work_dirs",
                        "chip_smoke_semkitti")


def check_converter(dev) -> tuple:
    """Phase 10, the checkpoint converter: phase 8's seeded ``video_r50_1x``
    weights saved as an mmcv-style ``.pth`` (``state_dict`` and a ``meta``
    with a ``datetime`` and an ``OrderedDict``), converted by ``python -m
    polyphonicformer_torch.tools.convert_torch_ckpt --video``
    (``weights_only=True``), equal bit for bit to phase 8's directly
    pickled variables; then ``tools/eval_video.py`` from the converted
    ``.pkl`` over the first clip of phase 8's split, its dumps bit-equal to
    phase 8's clip run."""
    import collections
    import datetime
    import os

    import numpy as np
    import torch

    from polyphonicformer_torch.evalutils.dvpq import list_frames
    from polyphonicformer_torch.tools import eval_video
    from polyphonicformer_torch.weights import flatten_tree, load_variables

    kernels = _kernels()
    work = _eval_dir()
    root, direct = os.path.join(work, "data"), os.path.join(work, "video_r50_1x_seed0.pkl")
    _, model, _ = _serving_model("video_r50_1x", dev)
    pth, out = os.path.join(work, "video_r50_1x_seed0.pth"), os.path.join(work, "converted.pkl")
    meta = {"mmdet_version": "2.14.0", "time": datetime.datetime.now(),
            "config": collections.OrderedDict(model="PolyphonicFormer", lr=2e-4)}
    torch.save({"state_dict": collections.OrderedDict(
        (k, v.detach().cpu()) for k, v in model.state_dict().items()), "meta": meta}, pth)
    del model
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "polyphonicformer_torch.tools.convert_torch_ckpt", "--ckpt", pth,
         "--out", out, "--video"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    _check("converter", proc.returncode == 0, proc.stdout[-1000:] + proc.stderr[-3000:])
    got, want = load_variables(out), load_variables(direct)
    for coll in ("params", "batch_stats"):
        g, w = flatten_tree(got[coll]), flatten_tree(want[coll])
        _check(f"converter {coll}", set(g) == set(w) and all(
            g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]) for k in w),
            "the converted variables differ from the directly pickled ones")

    conv_dir = os.path.join(work, "clip_converted")
    for k in kernels.values():
        k.launches = 0
    eval_video.main(["--data-root", root, "--checkpoint", out, "--preset", "video_r50_1x",
                     "--bf16", "--workers", str(EVAL_WORKERS), "--eval-dir", conv_dir,
                     "--clip-len", str(EVAL_FRAMES), "--max-frames", str(EVAL_FRAMES),
                     "--skip-aggregate"])
    launches = _count_launches(kernels, PER_FRAME, EVAL_FRAMES, "converted eval_video")
    compared = 0
    for kind in ("pred", "gt"):
        dumps = list_frames(conv_dir, kind)
        _check(f"converted {kind} dumps", len(dumps) == EVAL_FRAMES, f"{len(dumps)} dumps")
        for p in dumps:
            fa = np.load(p)
            fb = np.load(os.path.join(work, "clip", kind, os.path.basename(p)))
            for key in ("panseg", "depth"):
                _check(f"converted {kind} {os.path.basename(p)} {key}",
                       fa[key].dtype == fb[key].dtype and np.array_equal(fa[key], fb[key]),
                       "differs from phase 8's clip run")
            compared += 1
    return {"convert_s": convert_s, "pth_mib": os.path.getsize(pth) / 2 ** 20,
            "pkl_mib": os.path.getsize(out) / 2 ** 20, "variables_bit_equal": True,
            "dumps_bit_equal": compared, "launches": launches}, launches


def _loader_batch(root: str, cfg):
    """One batch of ``cfg``'s train loader (thread backend, one worker,
    seed 0, on the CPU) over the split at ``root``, its images normalised
    to f32."""
    import torch

    from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
    from polyphonicformer_torch.data.loader import TrainLoader
    from polyphonicformer_torch.train.step import normalize_uint8_image

    dc = cfg.data
    ds = CityscapesDVPSDataset(root, split="train", ref_sample_mode=dc.ref_sample_mode,
                               ref_seq_index=dc.ref_seq_index, with_depth=True)
    loader = TrainLoader(ds, dc, cfg.model, seed=0, num_workers=1, device="cpu")
    it = iter(loader)
    try:
        batch = next(it)
    finally:
        loader.stop()

    def image(x):
        return normalize_uint8_image(x, dc.mean, dc.std) if x.dtype == torch.uint8 else x

    return batch._replace(image=image(batch.image), ref_image=image(batch.ref_image))


def run_semkitti(dev, ckpt: str) -> tuple:
    """Phase 10, SemKITTI-DVPS: a train split of SEMKITTI_SEQS x
    SEMKITTI_FRAMES frames and a val split of SEMKITTI_VAL_SEQS x
    SEMKITTI_VAL_FRAMES at 376x1241 in the SemKITTI-DVPS layout (class and
    instance PNGs, the focal length in the depth name; Paeth rows, ~20
    things a frame), ``tools/train.py --preset video_r50_semkitti_1x
    --loader process`` at batch SEMKITTI_BATCH, f32, from ``ckpt`` for
    SEMKITTI_STEPS steps with the eval hook, then ``tools/eval_video.py
    --preset video_r50_semkitti_1x --bf16`` in clip mode over the val split
    (DVPQ and STQ); before them a debug-width ``semantic_kitti`` batch-2
    video step from the train loader over a 94x310 SemKITTI split (crop
    96x320, nearest GT downsample) on the card against the card's plain
    route, its distance from the CPU's f64 step reported."""
    import dataclasses
    import math
    import os
    import shutil

    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.synthetic_split import write_semkitti_split
    from polyphonicformer_torch.evalutils import runner
    from polyphonicformer_torch.tools import eval_video, train

    kernels = _kernels()
    work = _semkitti_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    eval_runs, real_eval = [], runner.evaluate_frames

    def counted_eval(*a, **kw):  # the hook's launches, apart from the steps'
        before = {n: k.launches for n, k in kernels.items()}
        result = real_eval(*a, **kw)
        eval_runs.append({n: k.launches - before[n] for n, k in kernels.items()})
        return result

    runner.evaluate_frames = counted_eval
    try:
        root, small = os.path.join(work, "data"), os.path.join(work, "small")
        h, w = SEMKITTI_HW
        t0 = time.perf_counter()
        write_semkitti_split(root, "train", SEMKITTI_SEQS, SEMKITTI_FRAMES, h, w, seed=0,
                             filter_type=4)
        write_semkitti_split(root, "val", SEMKITTI_VAL_SEQS, SEMKITTI_VAL_FRAMES, h, w, seed=1,
                             filter_type=4)
        write_s = time.perf_counter() - t0
        write_semkitti_split(small, "train", 2, 4, *SEMKITTI_SMALL_HW, seed=2)
        sk, tiny = preset("video_r50_semkitti_1x"), preset("debug_tiny_video")
        small_cfg = dataclasses.replace(
            tiny, model=dataclasses.replace(tiny.model, semantic_kitti=True),
            data=dataclasses.replace(sk.data, img_size=SEMKITTI_SMALL_CROP,
                                     batch_size=SEMKITTI_BATCH))
        host = _loader_batch(small, small_cfg)
        info = {"preset": "video_r50_semkitti_1x", "hw": [h, w], "batch": SEMKITTI_BATCH,
                "split_write_s": write_s,
                "small_reference": check_step_reference(
                    dev, small_cfg, lambda device: _to_device(host, device), "card_plain")}

        sets = [f"data.batch_size={SEMKITTI_BATCH}", "data.repeat_times=1",
                f"schedule.log_interval={TRAIN_LOG_INTERVAL}"]
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train.main(["--preset", "video_r50_semkitti_1x", "--data-root", root,
                          "--work-dir", os.path.join(work, "run"), "--load-from", ckpt,
                          "--loader", "process", "--max-steps", str(SEMKITTI_STEPS),
                          "--set", *sets])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        evals = {n: sum(r[n] for r in eval_runs) for n in kernels}
        n_steps = out["end_step"] - out["start_step"]
        steps_only = {n: k.launches - evals[n] for n, k in kernels.items()}
        for n, v in steps_only.items():
            _check(f"semkitti train launches {n}", v == PER_STEP.get(n, 0) * n_steps,
                   f"{v} launches in {n_steps} steps, expected {PER_STEP.get(n, 0)} a step")
        n_val = SEMKITTI_VAL_SEQS * SEMKITTI_VAL_FRAMES
        n_frames = len(out["evals"]) * n_val
        for n, v in evals.items():
            _check(f"semkitti eval hook launches {n}",
                   v == SEMKITTI_EVAL_PER_FRAME.get(n, 0) * n_frames,
                   f"{v} launches in {n_frames} eval frames")
        train_launches = {n: k.launches for n, k in kernels.items()}
        spe = out["steps_per_epoch"]
        _check("semkitti evals", [e["step"] for e in out["evals"]]
               == list(range(spe, SEMKITTI_STEPS + 1, spe)) and all(
                   math.isfinite(v) for e in out["evals"] for v in e["metrics"].values()),
               json.dumps(out["evals"]))
        lines = _metric_lines(out["metrics_path"])

        eval_dir = os.path.join(work, "eval")
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = eval_video.main(["--data-root", root, "--checkpoint", ckpt, "--preset",
                               "video_r50_semkitti_1x", "--bf16", "--workers", str(EVAL_WORKERS),
                               "--eval-dir", eval_dir, "--clip-len", str(SEMKITTI_VAL_FRAMES),
                               "--eval-stq", "--nproc", "8"])
        eval_s = time.perf_counter() - t0
        eval_launches = _count_launches(kernels, SEMKITTI_EVAL_PER_FRAME, n_val,
                                        "semkitti eval_video")
        results = res["results"]
        _check("semkitti dvpq", all(math.isfinite(v) for v in results["average"].values())
               and all(math.isfinite(v) for v in results["stq"].values()), json.dumps(results))
    finally:
        runner.evaluate_frames = real_eval
        shutil.rmtree(work, ignore_errors=True)

    walls = [s * 1e3 for s in out["step_wall_s"][1:]]
    last = slice(-TRAIN_LOG_INTERVAL, None)
    inf = res["inference"]
    info.update({
        "train_cli": {
            "cli_wall_s": cli_s, "steps": n_steps,
            # the last log interval: no save or evaluation inside it
            "steady_samples_per_s": lines[-1]["samples_per_sec"],
            "median_step_wall_ms": statistics.median(walls),
            "steady_median_step_wall_ms": statistics.median(walls[last]),
            "steady_median_sample_wait_ms": statistics.median(
                s * 1e3 for s in out["sample_wait_s"][1:][last]),
            "total_loss": [r["total_loss"] for r in lines], "peak_mem_gib": peak / 2 ** 30,
            "launches_a_step": {n: steps_only[n] / n_steps for n in PER_STEP},
            "eval_hook": [{"step": e["step"], "s": e["s"], "pq@inf": e["metrics"]["pq@inf"]}
                          for e in out["evals"]]},
        "eval_video": {"frames": n_val, "clip_len": SEMKITTI_VAL_FRAMES,
                       "frames_per_s": inf["frames_per_s"],
                       "steady_frames_per_s": inf["steady_frames_per_s"],
                       "cli_wall_s": eval_s, "aggregate_s": res["aggregate_s"],
                       "dvpq_average": results["average"], "stq": results["stq"],
                       "launches_a_frame": {n: eval_launches[n] / n_val
                                            for n in SEMKITTI_EVAL_PER_FRAME}}})
    launches = {n: train_launches[n] + eval_launches[n] for n in kernels}
    info["launches"] = launches
    return info, launches


def _to_device(batch, device):
    from polyphonicformer_torch.data.structures import GTSample

    return batch._replace(image=batch.image.to(device), ref_image=batch.ref_image.to(device),
                          gt=GTSample(*(t.to(device) for t in batch.gt)),
                          ref_gt=GTSample(*(t.to(device) for t in batch.ref_gt)))


def run_stdc_aspp(dev) -> tuple:
    """Phase 10, STDC and ASPP: ``image_r50_2x`` with OPTIONS_SETS (the
    CLIs' ``--set``) trained OPTIONS_STEPS steps at 1024x2048, batch 1, f32
    (ASPP_PER_STEP launches a step, ``loss_aspp_semseg`` finite, the STDC
    stem trained); the same configuration at debug widths, 64x128, on the
    card against the card's plain route, and with cuDNN off against the
    CPU's f64 step (``check_step_reference``); an 8-frame 1024x2048 bf16 clip of
    ``video_r50_1x`` on ``stdc813`` (PER_FRAME launches a frame)."""
    import torch

    from polyphonicformer_torch.configs import apply_overrides, parse_overrides, preset
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import PolyphonicFormer
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    kernels = _kernels()
    cfg = apply_overrides(preset("image_r50_2x"), parse_overrides(OPTIONS_SETS))
    _check("options config", cfg.model.backbone == "stdc1446" and cfg.model.with_semantic_aspp,
           f"{cfg.model.backbone} {cfg.model.with_semantic_aspp}")
    h, w = OPTIONS_HW
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt)
    batch = synthetic_batch(cfg.model, 1, (h, w), seed=0, max_instances=24, device=dev)
    stem = state.model.backbone.stem0.conv.weight.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    step_s, metrics = [], []
    for _ in range(OPTIONS_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = _count_launches(kernels, ASPP_PER_STEP, OPTIONS_STEPS, "stdc+aspp train")
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        _finite_metrics(f"stdc+aspp step {i}", m)
        _check(f"stdc+aspp step {i}", m.get("loss_aspp_semseg", 0.0) > 0.0,
               "no loss_aspp_semseg")
    _check("stdc stem trained", not torch.equal(state.model.backbone.stem0.conv.weight, stem),
           "the STDC stem did not move")
    del state, opt, step, model, batch
    torch.cuda.empty_cache()

    small = apply_overrides(preset("debug_tiny"), parse_overrides(OPTIONS_SETS))
    reference = check_step_reference(
        dev, small, lambda device: synthetic_batch(small.model, 1, (64, 128), seed=0,
                                                   max_instances=6, device=device),
        "card_plain", video=False, per_step=ASPP_PER_STEP, cudnn_witness=True)

    scfg, smodel, sgen = _serving_model("video_r50_1x", dev, backbone="stdc813")
    frames = _frames(sgen, 8, h, w, 64, dev)
    # random STDC weights need not score a thing above the tracker's
    # thresholds: the launches a frame are the same either way (reported)
    serve_launches, serve = _serve_clip("stdc813 clip", smodel, scfg, frames, PER_FRAME, dev,
                                        require_tracks=False)
    serve["preset"] = "video_r50_1x, model.backbone=stdc813"
    del smodel, frames
    torch.cuda.empty_cache()
    info = {"train": {"preset": "image_r50_2x", "set": OPTIONS_SETS, "hw": [h, w], "batch": 1,
                      "dtype": "float32", "cold_step_s": step_s[0],
                      "warm_steps_ms": [s * 1e3 for s in step_s[1:]],
                      "median_warm_step_ms": statistics.median(s * 1e3 for s in step_s[1:]),
                      "peak_mem_gib": peak / 2 ** 30,
                      "loss_aspp_semseg": [m["loss_aspp_semseg"] for m in metrics],
                      "total_loss": [m["total_loss"] for m in metrics], "launches": launches},
            "small_reference": reference, "serve_stdc813": serve}
    return info, {n: launches[n] + serve_launches[n] for n in kernels}


def _seeded_head(head, seed: int):
    """Seeded weights for a ``UperNetAlignHead``: kernels at 1/sqrt of their
    fan-in (the offset conv's too, so that the deformable taps move), BN
    statistics and affines away from identity."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*head.named_parameters(), *head.named_buffers()]:
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif name.endswith(("running_mean", "bias")):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif t.dim() == 1:
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen) / t[0].numel() ** 0.5)
    return head


def check_aligned_fpn(dev) -> dict:
    """Phase 10, the flow-aligned FPN (``UperNetAlignHead`` v1 and v2,
    standalone as the JAX package tests it): at a small size (levels of
    64-512 channels, 16x32 to 2x4) on the card against the CPU, within
    FPN_RTOL of max |cpu|; then once at the R50 FPN shapes of a 1024x2048
    image (four levels of 256 channels, 256x512 to 32x64): warm ms (median
    of 3, CUDA events) and peak memory."""
    import copy

    import torch

    from polyphonicformer_torch.models.aligned_fpn import UperNetAlignHead

    out = {"tolerance": FPN_RTOL}
    g = torch.Generator().manual_seed(7)
    small = ((64, 16, 32), (128, 8, 16), (256, 4, 8), (512, 2, 4))
    feats = [torch.randn((1, c, fh, fw), generator=g) for c, fh, fw in small]
    for v in ("v1", "v2"):
        cpu = _seeded_head(UperNetAlignHead([c for c, _, _ in small], 64, v), 1)
        gpu = copy.deepcopy(cpu).to(dev)
        with torch.no_grad():
            want = cpu(feats)
            got = gpu([f.to(dev) for f in feats]).cpu()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        _check(f"aligned fpn {v}", got.shape == (1, 64, 8, 16) and rel <= FPN_RTOL,
               f"{tuple(got.shape)}, max err {rel} of max |cpu|")
        out[f"small_{v}_max_rel_err"] = rel
    gd = torch.Generator(device=dev)
    gd.manual_seed(8)
    fh, fw = OPTIONS_HW
    feats = [torch.randn((1, 256, fh // s, fw // s), generator=gd, device=dev)
             for s in (4, 8, 16, 32)]
    for v in ("v1", "v2"):
        head = _seeded_head(UperNetAlignHead([256] * 4, 256, v), 2).to(dev)
        with torch.no_grad():
            head(feats)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                y = head(feats)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        _check(f"aligned fpn full {v}", y.shape == (1, 256, fh // 8, fw // 8)
               and bool(torch.isfinite(y).all()), f"{tuple(y.shape)}")
        out[f"full_{v}"] = {"ms": statistics.median(times), "ms_all": times,
                            "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
        del head, y
    return out


def run_options(dev):
    """Phase 10: the model options (converter, SemKITTI-DVPS, STDC + ASPP,
    the aligned FPN), each counting its kernel launches."""
    import os

    kernels = _kernels()
    info, launches = {}, {n: 0 for n in kernels}
    ckpt = os.path.join(_eval_dir(), "video_r50_1x_seed0.pkl")
    for key, fn in (("converter", check_converter),
                    ("semkitti", lambda d: run_semkitti(d, ckpt)),
                    ("stdc_aspp", run_stdc_aspp)):
        info[key], part = fn(dev)
        print(f"[10 {key}] {json.dumps(info[key])}", flush=True)
        launches = {n: launches[n] + part[n] for n in kernels}
    info["aligned_fpn"] = check_aligned_fpn(dev)
    print(f"[10 aligned_fpn] {json.dumps(info['aligned_fpn'])}", flush=True)
    return launches, info



EXPORT_HW = (1024, 2048)  # phase 11's frames
EXPORT_FRAMES = 8  # frames of the loaded frame artifact, carrying the tracker state
SWIN_EXPORT_FRAMES = 3
FLOPS_MODELS = (("video_r50_1x", {}), ("video_swinl", {}),
                ("video_r50_1x", {"backbone": "stdc813"}))
# the child that loads the frame artifact: no model, no configuration
ARTIFACT_RUNNER = r"""
import json, sys, time
import torch
import chip_smoke
from polyphonicformer_torch.infer.tracker import TrackerState
from polyphonicformer_torch.tools.export import load_serving
from polyphonicformer_torch.utils.profiling import StepTimer
import polyphonicformer_torch.models.polyphonic as P
def built(*a, **k):
    raise AssertionError("a model was built")
P.PolyphonicFormer.__init__ = built
torch.backends.cuda.matmul.allow_tf32 = False  # as the parent: full f32 math
torch.backends.cudnn.allow_tf32 = False
dev = torch.device(sys.argv[3])
inp = torch.load(sys.argv[2], weights_only=True, map_location=dev)
t0 = time.perf_counter()
fn = load_serving(sys.argv[1])
load_s = time.perf_counter() - t0
kernels = chip_smoke._kernels()
for k in kernels.values():
    k.launches = 0
state, frames, ids = TrackerState(**inp["state"]), inp["frames"], inp["frame_ids"]
timer, digests = StepTimer(warmup=2, device=dev), []
for i in range(frames.shape[0]):
    with timer:
        out, state = fn(inp["sd"], frames[i:i + 1], state, ids[i])
    digests.append(chip_smoke._digests((out, state)))
print(json.dumps({"load_s": load_s, "digests": digests, "timer": timer.summary(),
                  "launches": {n: k.launches for n, k in kernels.items()}}))
"""


def _leaves(x) -> list:
    """The leaves of nested tuples, NamedTuples, lists and dataclasses."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return [y for f in dataclasses.fields(x) for y in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _leaves(item)]
    return [x]


def _digests(tree) -> list:
    """sha256 of each tensor leaf's bytes (dtype and shape with it), repr of
    the other leaves: equal lists mean bit-equal trees."""
    import hashlib

    import torch

    out = []
    for x in _leaves(tree):
        if torch.is_tensor(x):
            t = x.detach().cpu().contiguous()
            h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
            out.append(h.hexdigest())
        else:
            out.append(repr(x))
    return out


def _reset(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def _eager_frames(step, frames, state, ids, dev):
    """``step`` over the frames carrying the state, each step timed by the
    port's StepTimer (warmup 2): the digests of each frame's outputs and
    state, and the timer's summary."""
    from polyphonicformer_torch.utils.profiling import StepTimer

    timer, digests = StepTimer(warmup=2, device=dev), []
    for i in range(frames.shape[0]):
        with timer:
            out, state = step(frames[i:i + 1], state, ids[i])
        digests.append(_digests((out, state)))
    return digests, timer.summary()


def _export_mode(model, cfg, mode: str, path: str, **kw) -> dict:
    """Export ``mode`` of ``model`` (bf16), save it to ``path``: seconds,
    bytes, the graph's poly:: ops, its nodes and its casts."""
    import os

    import torch

    from polyphonicformer_torch.tools import export

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program = export.export_program(model, cfg, mode, EXPORT_HW, bf16=True, **kw)
    export_s = time.perf_counter() - t0
    torch.export.save(program, path)
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {"export_s": export_s, "bytes": os.path.getsize(path),
            "poly_ops": export.poly_ops(program), "graph_nodes": len(nodes),
            # the state dict's cast to bf16 inside the program, every call,
            # and the model's own casts; and the checks export puts before
            # a cast
            "cast_nodes": sum(t.startswith("aten.to.") for t in nodes),
            "assert_nodes": nodes.count("aten._assert_tensor_metadata.default")}


def _export_frame_path(tag, preset, per_frame, frames_n, dev, work, fresh_process: bool):
    """Phase 11, frame mode of ``preset`` in bf16: the eager step over the
    frames, then the export loaded in a fresh process (``fresh_process``)
    or in this one, bit-equal to eager frame by frame with ``per_frame``
    launches a frame.  Returns (launches of both runs, info)."""
    import dataclasses
    import os

    import torch

    from polyphonicformer_torch.infer.pipeline import make_video_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.tools import export

    kernels = _kernels()
    cfg, model, gen = _serving_model(preset, dev)
    h, w = EXPORT_HW
    frames = _frames(gen, frames_n, h, w, 64, dev)
    ids = torch.arange(1, frames_n + 1, dtype=torch.int32, device=dev)
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    sd_bytes = sum(v.numel() * v.element_size() for v in model.state_dict().values())
    bf16 = torch.bfloat16
    step = make_video_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)
    _reset(kernels)
    eager, eager_t = _eager_frames(step, frames, state0, ids, dev)
    launches = _count_launches(kernels, per_frame, frames_n, f"{tag} eager")
    del step
    path = os.path.join(work, f"{preset}_frame.pt2")
    info = {"preset": preset, "hw": [h, w], "frames": frames_n, "dtype": "bfloat16",
            "state_dict_bytes": sd_bytes, "state_dict_entries": len(model.state_dict()),
            **_export_mode(model, cfg, "frame", path)}
    want_ops = {"mask_pool": per_frame["mask_pool"], "upsample_int": per_frame["upsample2"],
                "phase_fusion": per_frame["phase_fusion"], "render_maps": per_frame["map_render"]}
    for op in ("window_attention", "window_attn_math"):
        if per_frame.get(op):
            want_ops[op] = per_frame[op]
    _check(f"{tag} graph", info["poly_ops"] == want_ops, f"{info['poly_ops']} vs {want_ops}")
    _check(f"{tag} bytes", info["bytes"] < sd_bytes / 10,
           f"{info['bytes']} artifact bytes, state dict {sd_bytes}")
    if fresh_process:
        inputs = os.path.join(work, f"{preset}_inputs.pt")
        torch.save({"sd": model.state_dict(), "frames": frames, "frame_ids": ids,
                    "state": dataclasses.asdict(state0)}, inputs)
        del model
        torch.cuda.empty_cache()
        proc = subprocess.run([sys.executable, "-c", ARTIFACT_RUNNER, path, inputs, str(dev)],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        _check(f"{tag} artifact process", proc.returncode == 0,
               proc.stdout[-2000:] + proc.stderr[-4000:])
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        loaded, loaded_t, art_launches = child["digests"], child["timer"], child["launches"]
        info["load_s"] = child["load_s"]
        _check(f"{tag} artifact launches", all(
            art_launches[n] == per_frame.get(n, 0) * frames_n for n in art_launches),
            f"{art_launches}, expected {per_frame} x {frames_n}")
    else:
        t0 = time.perf_counter()
        fn = export.load_serving(path)
        info["load_s"] = time.perf_counter() - t0
        sd = model.state_dict()
        _reset(kernels)
        loaded, loaded_t = _eager_frames(lambda *a: fn(sd, *a), frames, state0, ids, dev)
        art_launches = _count_launches(kernels, per_frame, frames_n, f"{tag} artifact")
        del model, fn
    _check(f"{tag} artifact vs eager", loaded == eager,
           f"frames differing: {[i for i, (a, b) in enumerate(zip(loaded, eager)) if a != b]}")
    info.update({"bit_equal_frames": len(eager), "eager": eager_t, "artifact": loaded_t,
                 "eager_frames_per_s": eager_t["steps_per_sec"],
                 "artifact_frames_per_s": loaded_t["steps_per_sec"],
                 "launches_a_frame": {n: v / frames_n for n, v in art_launches.items() if v}})
    torch.cuda.empty_cache()
    return {n: launches[n] + art_launches[n] for n in launches}, info


def _export_stateless(dev, work) -> tuple:
    """Phase 11, the image mode and the clip mode (clip_len 2) of
    ``video_r50_1x`` in bf16, each loaded in this process and bit-equal to
    its eager step, PER_FRAME launches a frame."""
    import os

    import torch

    from polyphonicformer_torch.infer.pipeline import make_clip_step, make_image_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.tools import export

    kernels = _kernels()
    cfg, model, gen = _serving_model("video_r50_1x", dev)
    h, w = EXPORT_HW
    frames = _frames(gen, 2, h, w, 64, dev)
    sd, bf16 = model.state_dict(), torch.bfloat16
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    fid = torch.ones((), dtype=torch.int32, device=dev)
    # mode: (frames, the eager step, its call, the artifact's call)
    runs = {"image": (1, lambda: make_image_step(model, cfg, (h, w), bf16, bf16),
                      lambda fn: fn(frames[:1]), lambda fn: fn(sd, frames[:1])),
            "clip": (2, lambda: make_clip_step(model, cfg, (h, w), bf16, bf16),
                     lambda fn: fn(frames, state0, fid), lambda fn: fn(sd, frames, state0, fid))}
    info, launches = {}, {n: 0 for n in kernels}
    for mode, (n, make, call_eager, call_art) in runs.items():
        want = _digests(call_eager(make()))
        path = os.path.join(work, f"video_r50_1x_{mode}.pt2")
        info[mode] = _export_mode(model, cfg, mode, path, **({"clip_len": 2} if mode == "clip"
                                                               else {}))
        fn = export.load_serving(path)
        _reset(kernels)
        got = _digests(call_art(fn))
        part = _count_launches(kernels, PER_FRAME, n, f"{mode} artifact")
        _check(f"{mode} artifact vs eager", got == want, "outputs differ")
        info[mode]["bit_equal_leaves"] = len(got)
        launches = {k: launches[k] + part[k] for k in launches}
    return launches, info


def _flops(dev) -> dict:
    """Phase 11, ``tools/flops.py`` on the card at 1024x2048: the presets
    through ``analyze``, the STDC813 model through ``count``."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.tools import flops

    out = {}
    for preset, repl in FLOPS_MODELS:
        name = repl.get("backbone", preset)
        t0 = time.perf_counter()
        if repl:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            model = build_model(model_preset(preset, **repl), dev, generator=gen)
            res = flops.count(model, torch.zeros((1, *EXPORT_HW, 3), device=dev))
            del model
        else:
            res = flops.analyze(preset, EXPORT_HW, 1, dev)
        _check(f"flops {name}", res["params_M"] > 0 and res["flops_G"] > 0
               and res["bytes_accessed_GB"] > 0, json.dumps(res))
        out[name] = {**res, "wall_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    return out


def _parity(work) -> dict:
    """Phase 11, ``tools/parity_check.py`` on phase 8's split: phase 10's
    seeded ``video_r50_1x`` ``.pth`` and the same weights without the track
    head as the image model's ``.pth``, bf16, as phase 8 evaluates.  The
    measured values equal phase 8's DVPQ cells and its ``eval_image``
    metrics (the same weights: the image preset's model is the video
    preset's without the track head); the gates set to phase 8's values
    pass (exit 0), and with PQ moved by twice its tolerance the image stage
    fails (exit 1)."""
    import os

    import torch

    from polyphonicformer_torch.tools import parity_check
    from polyphonicformer_torch.tools.convert_torch_ckpt import load_torch_state_dict

    root = os.path.join(work, "data")
    video_pth = os.path.join(work, "video_r50_1x_seed0.pth")
    image_pth = os.path.join(work, "image_r50_seed0.pth")
    sd = load_torch_state_dict(video_pth)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()
                               if not k.startswith("track_head.")}}, image_pth)
    with open(os.path.join(work, "clip", "dvpq.json")) as f:
        dvpq = json.load(f)
    with open(os.path.join(work, "eval_image.json")) as f:
        image = json.load(f)
    phase8 = {f"dvpq_{cell}" if name == "pq" else f"dvpq_{cell}_{name[3:]}": v
              for cell, vals in dvpq.items() if cell != "stq" for name, v in vals.items()}
    phase8["dvpq_average"] = dvpq["average"]["pq"]
    phase8.update({k: v for k, v in image.items() if v is not None})
    gates = {k: phase8[k] for k in ("pq@inf", "depth_abs_rel", "dvpq_average")}
    common = ["--data-root", root, "--preset-image", "image_r50_2x", "--bf16"]
    t0 = time.perf_counter()
    rc = parity_check.main(common + [
        "--image-pth", image_pth, "--video-pth", video_pth, "--preset-video", "video_r50_1x",
        "--clip-len", str(EVAL_FRAMES), "--workers", str(EVAL_WORKERS), "--nproc", "8",
        "--workdir", os.path.join(work, "parity"),
        "--expected", *[f"{k}={v!r}" for k, v in gates.items()]])
    wall_s = time.perf_counter() - t0
    with open(os.path.join(work, "parity", "parity.json")) as f:
        measured = json.load(f)
    differ = sorted(k for k in set(measured) | set(phase8) if measured.get(k) != phase8.get(k))
    _check("parity measured", not differ, f"keys differing from phase 8's: {differ[:8]}")
    _check("parity gates pass", rc == 0, f"exit {rc}")
    moved = f"pq@inf={gates['pq@inf'] + 0.002!r}"
    rc_fail = parity_check.main(common + ["--image-pth", image_pth, "--workdir",
                                          os.path.join(work, "parity_fail"), "--expected", moved])
    _check("parity moved gate fails", rc_fail == 1, f"exit {rc_fail}")
    return {"measured_keys": len(measured), "equal_to_phase8": True, "exit_pass": rc,
            "exit_moved_gate": rc_fail, "wall_s": wall_s, "gates": gates}


def _host_lsa(dev) -> dict:
    """Phase 11, the host solver ``ops/native.py::lsap_solve`` on phase 3's
    K5 problems (``kernel_probe._phase3_lsa_problems``): each problem's
    valid rows of the prepared costs give K5's assignment."""
    import numpy as np

    from polyphonicformer_torch.ops import native
    from polyphonicformer_torch.ops.cuda import lsa
    from polyphonicformer_torch.tools import kernel_probe

    costs, valid = kernel_probe._phase3_lsa_problems(dev)
    k5 = lsa.solve_lsa(costs, valid).cpu().numpy()
    prepared, valid_np = lsa.prepare(costs, valid).cpu().numpy(), valid.cpu().numpy()
    rows = 0
    for i in range(costs.shape[0]):
        got = native.lsap_solve(prepared[i][valid_np[i]])
        _check(f"host lsa problem {i}", np.array_equal(got, k5[i][valid_np[i]]),
               f"{got.tolist()} vs {k5[i][valid_np[i]].tolist()}")
        rows += len(got)
    return {"problems": int(costs.shape[0]), "rows": rows, "equal": True}


def run_tools(dev):
    """Phase 11: the tools.  Export (``video_r50_1x`` frame mode over 8
    frames loaded in a fresh process, image and clip modes, ``video_swinl``
    frame mode), FLOPs, the parity runbook on phase 8's split with phase
    10's ``.pth``, and the host LSA solver."""
    import os

    kernels = _kernels()
    work = _eval_dir()
    info, launches = {}, {n: 0 for n in kernels}
    for key, fn in (
            ("export_frame", lambda: _export_frame_path(
                "r50 artifact", "video_r50_1x", PER_FRAME, EXPORT_FRAMES, dev, work, True)),
            ("export_image_clip", lambda: _export_stateless(dev, work)),
            ("export_swinl", lambda: _export_frame_path(
                "swinl artifact", "video_swinl", SWIN_PER_FRAME, SWIN_EXPORT_FRAMES, dev, work,
                False))):
        part, info[key] = fn()
        print(f"[11 {key}] {json.dumps(info[key])}", flush=True)
        launches = {n: launches[n] + part[n] for n in kernels}
        for name in os.listdir(work):
            if name.endswith((".pt2", "_inputs.pt")):
                os.remove(os.path.join(work, name))
    for key, fn in (("flops", lambda: _flops(dev)), ("parity", lambda: _parity(work)),
                    ("host_lsa", lambda: _host_lsa(dev))):
        info[key] = fn()
        print(f"[11 {key}] {json.dumps(info[key])}", flush=True)
    return launches, info


if __name__ == "__main__":
    sys.exit(main())
