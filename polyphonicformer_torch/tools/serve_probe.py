"""Serving walls on one CUDA card, beside ``chip_smoke.py``'s phases 4 and 11.

    python -m polyphonicformer_torch.tools.serve_probe [--parts frames,artifact]

Parts, one JSON line each, then the card's name and power limit; both on
``video_r50_1x`` in bf16 at 1024x2048 with seeded weights (the last
stage's ``fc_cls`` bias 0, as phase 4) and an 8-frame synthetic clip:

* ``frames``: after 3 warm clips, 6 clips through ``make_clip_step``
  (frames/s each) and 24 frames through ``make_video_step``, each closed by
  a synchronize (latency).  It calls only entry points that earlier
  versions of the package have too, so the tool can be copied into an
  older checkout and run there, in turns with this one, to compare them.
* ``artifact``: the serving frame eager and through its ``tools/export.py``
  artifact loaded back: the host wall of a frame (median of 5), the device
  events and busy ms of one profiled frame, its 10 ops of most self CPU
  time, and the graph's nodes, casts and assertions.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HW = (1024, 2048)


def _setup(dev):
    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("video_r50_1x")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = build_model(cfg, dev, generator=gen)
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    h, w = HW
    base = torch.randn((1, h // 64, w // 64, 3), generator=gen, device=dev) * 2
    base = base.repeat_interleave(64, 1).repeat_interleave(64, 2)
    return cfg, model, base + 0.1 * torch.randn((8, h, w, 3), generator=gen, device=dev)


def frames(dev) -> dict:
    import torch

    from polyphonicformer_torch.infer.pipeline import make_clip_step, make_video_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state

    cfg, model, clip_frames = _setup(dev)
    bf16 = torch.bfloat16
    clip = make_clip_step(model, cfg, HW, bf16, bf16)
    step = make_video_step(model, cfg, HW, bf16, bf16)
    state0 = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    for _ in range(3):
        clip(clip_frames, state0, 1)
    torch.cuda.synchronize()
    clip_s = []
    for _ in range(6):
        t0 = time.perf_counter()
        clip(clip_frames, state0, 1)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
    latency, state = [], state0
    for i in range(24):
        t0 = time.perf_counter()
        _, state = step(clip_frames[i % 8:i % 8 + 1], state, i + 1)
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t0) * 1e3)
    return {"clip_fps": [8 / s for s in clip_s],
            "median_clip_fps": 8 / statistics.median(clip_s),
            "median_frame_latency_ms": statistics.median(latency)}


def _busy_ms(prof) -> tuple:
    """(device events, ms of their union) of a profile."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    return len(spans), busy / 1e3


def artifact(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyphonicformer_torch.infer.pipeline import make_video_step
    from polyphonicformer_torch.infer.tracker import init_tracker_state
    from polyphonicformer_torch.tools import export

    cfg, model, clip_frames = _setup(dev)
    frame = clip_frames[:1]
    state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    fid = torch.ones((), dtype=torch.int32, device=dev)
    bf16 = torch.bfloat16
    eager = make_video_step(model, cfg, HW, bf16, bf16)
    fn = export.load_serving(export.export_serving(model, cfg, "frame", HW, bf16=True))
    sd = model.state_dict()
    nodes = [str(n.target) for n in fn.program.graph.nodes if n.op == "call_function"]
    out = {"graph_nodes": len(nodes), "cast_nodes": sum(t.startswith("aten.to.") for t in nodes),
           "assert_nodes": nodes.count("aten._assert_tensor_metadata.default"),
           "state_dict_entries": len(sd)}
    for name, call in (("eager", lambda: eager(frame, state, fid)),
                       ("artifact", lambda: fn(sd, frame, state, fid))):
        with torch.no_grad():
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        events, busy = _busy_ms(prof)
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        out[name] = {"median_wall_ms": statistics.median(walls), "device_events": events,
                     "device_busy_ms": busy,
                     "top_self_cpu_ms": {e.key: e.self_cpu_time_total / 1e3 for e in top}}
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="frames,artifact")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fns = {"frames": frames, "artifact": artifact}
    for part in args.parts.split(","):
        print(json.dumps({"part": part, **fns[part](dev)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
