"""Where the device time of the port's main paths goes, on one CUDA card.

    python -m polyphonicformer_torch.tools.profile_paths [unit ...]

Units of work, each at full width with seeded random weights:

* ``serve_frame``: one warm 1024x2048 frame of the R50 video serving path
  (``video_r50_1x``, ``make_video_step``, bf16 network and fusion);
* ``train_step_f32``: one warm 1024x2048 train step of ``image_r50_2x``
  (batch 1, ``make_train_step`` with its non-finite guard, f32, TF32 off);
* ``train_step_bf16``: the same step with ``compute_dtype="bfloat16"``;
* ``train_video``: one warm 1024x2048 2-frame train step of
  ``video_r50_1x`` (batch 1, ``make_train_step(video=True)``, f32, TF32
  off): the key frame's losses, the ref frame's features, the track losses;
* ``serve_frame_swinl``: one warm frame of the Swin-L path
  (``video_swinl``, bf16 network and fusion);
* ``serve_batched_swinl``: one warm ``batched_video_step`` over 2 clips of
  the Swin-L path.

For each: the median wall time of warm runs (host clock closed by
``torch.cuda.synchronize()``, not profiled) and peak device memory; then
one run under ``torch.profiler`` with CUDA activity: its own wall time
(``profiled_wall_ms``, closed the same way), the device's busy time (the
union of the intervals of its kernels, copies and sets), the idle share of
the profiled run's wall that leaves, the number of kernels,
the device time by kernel class, the ten longest kernels, and the device
time and launches of each of the port's own kernels.  One JSON
line per unit on standard output, then the card's name and power limit.
Units named on the command line run alone; without names, all run.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

# device kernel name fragments -> class; the first class that matches wins
KERNEL_CLASSES = (
    ("port", ("mask_pool", "upsample_int", "phase_fusion", "map_render", "lsa_kernel",
              "mask_loss", "window_attn")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("matmul", ("gemm", "gemv", "cutlass", "cublas", "nvjet")),
    ("foreach", ("multi_tensor", "foreach")),
    ("norm", ("norm",)),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in KERNEL_CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _device_events(prof):
    """(name, start_us, end_us) of every kernel, copy and set the profiler
    saw on the card; the spans of annotations (such as the optimizer's
    step) cover idle time and are left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def measure(name: str, run, warm: int) -> dict:
    """``run()`` once cold, ``warm`` times timed, once profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    info = {"unit": name, "wall_ms": walls, "median_wall_ms": wall,
            "profiled_wall_ms": profiled_wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if not events:  # the profiler did not trace the card
        info.update(device_busy_ms=None, idle_share=None, kernels=None)
        return info
    busy = busy_us((s, e) for _, s, e in events) / 1e3
    by_class, by_name = {}, {}
    for kname, s, e in events:
        cls = kernel_class(kname)
        by_class[cls] = by_class.get(cls, 0.0) + (e - s) / 1e3
        ms, n = by_name.get(kname, (0.0, 0))
        by_name[kname] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    port = {k: (ms, n) for k, (ms, n) in by_name.items() if kernel_class(k) == "port"}
    info.update(
        device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / profiled_wall),
        kernels=len(events),
        device_ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[{"name": k[:100], "ms": ms, "count": n} for k, (ms, n) in top],
        port_kernels=[{"name": k[:100], "ms": ms, "count": n}
                      for k, (ms, n) in sorted(port.items(), key=lambda kv: -kv[1][0])])
    return info


def serve_frame(dev, preset: str = "video_r50_1x", clips: int = 0):
    """A frame of ``preset``'s serving path: ``make_video_step`` when
    ``clips`` is 0, else ``make_batched_video_step`` over that many clips."""
    import torch

    from ..configs import model_preset
    from ..infer.pipeline import (init_batched_tracker_states, make_batched_video_step,
                                  make_video_step)
    from ..infer.tracker import init_tracker_state
    from ..models import build_model

    cfg = model_preset(preset)
    h, w = 1024, 2048
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, generator=gen)
    with torch.no_grad():  # thing scores straddle instance_score_thr
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    # colour blocks plus noise, so that segments and detections exist
    n = max(clips, 1)
    base = torch.randn((n, h // 64, w // 64, 3), generator=gen, device=dev) * 2
    frame = base.repeat_interleave(64, 1).repeat_interleave(64, 2)
    frame = frame + 0.1 * torch.randn((n, h, w, 3), generator=gen, device=dev)
    kw = dict(compute_dtype=torch.bfloat16, fusion_dtype=torch.bfloat16)
    if clips:
        step = make_batched_video_step(model, cfg, (h, w), **kw)
        state = [init_batched_tracker_states(cfg, clips, dev), 1]
    else:
        step = make_video_step(model, cfg, (h, w), **kw)
        state = [init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev), 1]

    def run():
        fid = [state[1]] * clips if clips else state[1]
        _, state[0] = step(frame, state[0], fid)
        state[1] += 1

    return run


def train_step(dev, compute_dtype: str, video: bool = False):
    """A train step of ``image_r50_2x``, or with ``video`` a 2-frame step of
    ``video_r50_1x``."""
    import torch

    from ..configs import preset
    from ..data.synthetic import synthetic_batch
    from ..models import PolyphonicFormer
    from ..train.step import create_train_state, make_train_step

    cfg = preset("video_r50_1x" if video else "image_r50_2x")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             compute_dtype=compute_dtype))
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch=1000, device=dev)
    step = make_train_step(state.model, cfg, opt, video=video)
    batch = synthetic_batch(cfg.model, 1, (1024, 2048), two_frame=video, seed=0,
                            max_instances=24, device=dev)
    holder = [state]

    def run():
        holder[0], _ = step(holder[0], batch)

    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_paths: this run needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    units = (("serve_frame", lambda: serve_frame(dev), 12),
             ("train_step_f32", lambda: train_step(dev, "float32"), 8),
             ("train_step_bf16", lambda: train_step(dev, "bfloat16"), 8),
             ("train_video", lambda: train_step(dev, "float32", video=True), 8),
             ("serve_frame_swinl", lambda: serve_frame(dev, "video_swinl"), 12),
             ("serve_batched_swinl", lambda: serve_frame(dev, "video_swinl", clips=2), 8))
    chosen = sys.argv[1:] or [name for name, _, _ in units]
    unknown = set(chosen) - {name for name, _, _ in units}
    if unknown:
        print(f"profile_paths: unknown units {sorted(unknown)}", file=sys.stderr)
        return 2
    for name, build, warm in units:
        if name not in chosen:
            continue
        print(json.dumps(measure(name, build(), warm)), flush=True)
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
