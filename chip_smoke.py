"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases: (1) the device; (2) the build of the hand-written kernels from
``polyphonicformer_torch/csrc``; (3) each kernel against its plain PyTorch
version at the shapes the serving path gives it, with both timed; (4) the
R50 video serving path (``video_r50_1x``, seeded random weights) on an
8-frame 1024x2048 clip in bf16 through ``clip_video_step``, with the kernel
launch counts of that run.  Any failed phase raises, so the exit code is not
0.  The last two lines are a JSON object of per-kernel results and the JSON
result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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

    from polyphonicformer_torch.ops.cuda import map_render, mask_pool, phase_fusion, upsample2

    rows = []
    # K1 mask_pool: rpn head (100 rows) and each stage (111 rows); feats are
    # the NCHW module tensors seen as (B, h, w, C) views, bf16 on this path
    feats = torch.randn((1, 256, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
    feats_hwc = feats.permute(0, 2, 3, 1)
    err = 0.0
    for n in (100, 111):
        logits = torch.randn((1, n, 128, 256), generator=gen, device=dev).to(torch.bfloat16)
        got = mask_pool.masked_pool(logits, feats_hwc)
        torch.cuda.synchronize()
        want = mask_pool.mask_pool_plain(logits, feats_hwc)
        hard = (torch.sigmoid(logits.float()) > 0.5).float()
        bound = 1e-5 * torch.einsum("bnhw,bhwc->bnc", hard, feats_hwc.float().abs()) + 1e-6
        diff = (got - want).abs()
        _check(f"mask_pool n={n}", bool((diff <= bound).all()),
               f"max err {float(diff.max())} beyond rtol 1e-5 of sum|feat|")
        err = max(err, float(diff.max()))
    rows.append(dict(
        name="mask_pool", route="cuda", source="polyphonicformer_torch/csrc/mask_pool.cu",
        replaces="polyphonicformer_tpu/ops/pallas/mask_pool.py:45", max_abs_err=err,
        ms=_time_ms(lambda: mask_pool.masked_pool(logits, feats_hwc)),
        plain_ms=_time_ms(lambda: mask_pool.mask_pool_plain(logits, feats_hwc))))

    # K2 upsample: x2 of the stage mask/depth logits, x4 to full resolution
    err = 0.0
    for shape, f in (((111, 128, 256), 2), ((1, 128, 256), 2), ((1, 256, 512), 4)):
        x = torch.randn(shape, generator=gen, device=dev)
        got = upsample2.upsample_int(x, f)
        torch.cuda.synchronize()
        err = max(err, _exact(f"upsample x{f} {shape}", got, upsample2.upsample_int_plain(x, f, f)))
    x2 = torch.randn((111, 128, 256), generator=gen, device=dev)
    rows.append(dict(
        name="upsample2", route="cuda", source="polyphonicformer_torch/csrc/upsample.cu",
        replaces="polyphonicformer_tpu/ops/pallas/upsample2.py:154", max_abs_err=err,
        ms=_time_ms(lambda: upsample2.upsample_int(x2, 2)),
        plain_ms=_time_ms(lambda: upsample2.upsample_int_plain(x2, 2, 2))))

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
    rows.append(dict(
        name="phase_fusion", route="cuda", source="polyphonicformer_torch/csrc/phase_fusion.cu",
        replaces="polyphonicformer_tpu/ops/pallas/phase_fusion.py:126", max_abs_err=err,
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
        ms=_time_ms(lambda: map_render.render_maps(*args)),
        plain_ms=_time_ms(lambda: map_render.render_maps_plain(*args))))
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = check_kernels(dev, gen)
    for r in rows:
        print(f"[3 kernel] {r['name']}: max_abs_err {r['max_abs_err']} | kernel {r['ms']:.4f} ms "
              f"| plain {r['plain_ms']:.4f} ms", flush=True)

    launches, slice_info = run_slice(dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(f"[4 slice] {json.dumps(slice_info)}", flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


PER_FRAME = {"mask_pool": 7, "upsample2": 4, "phase_fusion": 1, "map_render": 1}


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


def run_slice(dev):
    """Phase 4: the R50 video serving path at full width, bf16."""
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import (make_clip_step, make_image_step,
                                                       make_video_step)
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.ops.cuda import map_render, mask_pool, phase_fusion, upsample2

    kernels = {"mask_pool": mask_pool.KERNEL, "upsample2": upsample2.KERNEL,
               "phase_fusion": phase_fusion.KERNEL, "map_render": map_render.KERNEL}
    cfg = model_preset("video_r50_1x")
    h, w, t = 1024, 2048, 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(cfg, dev, generator=gen)
    with torch.no_grad():  # thing scores straddle instance_score_thr
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    frames = _frames(gen, t, h, w, 64, dev)
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
    launches = {name: k.launches for name, k in kernels.items()}
    for name, per in PER_FRAME.items():
        _check(f"launches {name}", launches[name] == per * t,
               f"{launches[name]} launches, expected {per} x {t} frames")

    nc, nt = cfg.num_classes, cfg.num_thing_classes
    for field, dtype in (("semantic", torch.int32), ("panoptic", torch.int32),
                         ("track_map", torch.int32), ("depth", torch.float32)):
        v = getattr(out, field)
        _check(field, v.shape == (t, h, w) and v.dtype == dtype, f"{tuple(v.shape)} {v.dtype}")
    _check("semantic range", int(out.semantic.min()) >= 0 and int(out.semantic.max()) <= nc,
           f"[{int(out.semantic.min())}, {int(out.semantic.max())}]")
    _check("depth", bool(torch.isfinite(out.depth).all()) and float(out.depth.min()) >= 0
           and float(out.depth.max()) <= 80.0, f"[{float(out.depth.min())}, {float(out.depth.max())}]")
    _check("track ids on things", not bool((out.track_map[out.semantic >= nt] != 0).any()),
           "track id on a stuff or void pixel")
    # new tracklets come only from valid detections that reached tracker_step
    _check("detections", int(state.num_tracklets) > 0 and bool((out.track_map > 0).any()),
           "no detection reached the tracker")
    peak = torch.cuda.max_memory_allocated()

    # second, warm pass: the clip step as a whole, then frame by frame
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

    # image mode, a prefix of the same code
    pano = make_image_step(model, cfg, (h, w), compute_dtype=bf16, fusion_dtype=bf16)(frames[:1])
    _check("image step", pano.semantic.shape == (h, w) and int(pano.semantic.max()) <= nc
           and bool(torch.isfinite(pano.depth).all()), "image-mode maps")
    info = {
        "preset": "video_r50_1x", "hw": [h, w], "frames": t, "dtype": "bfloat16",
        "first_pass_s": first_s, "warm_clip_s": clip_s, "warm_clip_fps": t / clip_s,
        "median_frame_ms": median, "median_fps": 1000.0 / median,
        "peak_mem_gib": peak / 2 ** 30, "num_tracklets": int(state.num_tracklets),
        "frames_with_tracks": int((out.track_map > 0).flatten(1).any(1).sum()),
        "launches": launches, "small_reference_agree": check_small_reference(dev),
    }
    return launches, info


if __name__ == "__main__":
    sys.exit(main())
