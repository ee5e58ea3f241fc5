"""Video (DVPS) evaluation CLI: streaming per-frame inference with tracking,
then DVPQ over windows k in {1..4} x depth thresholds; the port of
``polyphonicformer_tpu/tools/eval_video.py``, with the same flags plus
``--device``.

    python -m polyphonicformer_torch.tools.eval_video --data-root DIR \\
        --checkpoint vars.pkl [--preset video_r50_1x] [--bf16] [--device cpu]

reference: tools/test_video.py + polyphonic/apis/{video_inference,
video_evaluate}.py.

Runs on the CUDA card unless ``--device cpu``; with no card it raises.
``--checkpoint`` is the JAX CLIs' ``.pkl`` of numpy variables
(``weights.load_variables``, mapped by ``weights.from_jax_variables``).
Frame-id convention: the tracker sees frame ids counted from 1 at each
sequence start (the reference counts from the sequence's img_id==0); track
expiry is relative to the current frame in both, so associations are
identical.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    """Returns ``{"inference": stats or None, "results": the dvpq.json
    content or None, "aggregate_s": its seconds or None}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--checkpoint", required=True, help="converted .pkl variables")
    ap.add_argument("--preset", default=None,
                    help="config preset (default: full R50 model)")
    ap.add_argument("--eval-dir", default="work_dirs/video_eval")
    ap.add_argument("--nproc", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--clip-len", type=int, default=6,
                    help="frames per clip step (6 = one Cityscapes-DVPS val "
                    "sequence); 1 = the per-frame streaming step")
    ap.add_argument("--workers", type=int, default=4,
                    help="PNG-decode worker processes (shared-memory ring)")
    ap.add_argument("--f32-depth", dest="f32_depth", action="store_true",
                    help="dump predicted depth as raw float32 meters (the "
                    "reference's dump dtype) instead of the uint16 1/256 m grid")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 network and fusion (the K3 fusion kernel)")
    ap.add_argument("--shard-id", type=int, default=0,
                    help="with --num-shards: process sequences with "
                    "seq_id %% num_shards == shard_id (one process per card, "
                    "shared eval dir, then aggregate once with --skip-infer)")
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--skip-infer", action="store_true",
                    help="only aggregate an existing eval dir")
    ap.add_argument("--skip-aggregate", action="store_true",
                    help="only run inference (aggregate later)")
    ap.add_argument("--set", nargs="*", dest="overrides",
                    help="dotted-path config overrides key=value")
    ap.add_argument("--eval-stq", action="store_true",
                    help="also aggregate STQ")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    from ..evalutils.dvpq import evaluate_dvpq
    from ..ops import native

    native.load()  # build the host library once, before any worker needs it
    out = {"inference": None, "results": None, "aggregate_s": None}
    if not args.skip_infer:
        out["inference"] = run_inference(args)
    if args.skip_aggregate:
        return out
    if args.num_shards > 1:
        # other shards may still be writing into the shared eval dir
        print(f"shard {args.shard_id}/{args.num_shards}: inference done; "
              "skipping aggregation (run once with --skip-infer when all "
              "shards have finished)")
        return out

    t0 = time.perf_counter()
    results = evaluate_dvpq(args.eval_dir, nproc=args.nproc)
    for key, val in results.items():
        print(f"DVPQ[{key}] : {val['pq']:.3f} thing {val['pq_thing']:.3f} "
              f"stuff {val['pq_stuff']:.3f}")
    if args.eval_stq:
        results["stq"] = aggregate_stq(args.eval_dir)
        print("STQ : " + "  ".join(f"{k} {v:.4f}"
                                   for k, v in results["stq"].items()))
    with open(os.path.join(args.eval_dir, "dvpq.json"), "w") as f:
        json.dump(results, f, indent=2)
    out["aggregate_s"] = time.perf_counter() - t0
    print(f"aggregation: {out['aggregate_s']:.2f} s", flush=True)
    out["results"] = results
    return out


def aggregate_stq(eval_dir: str) -> dict:
    """STQ over the saved pred/gt frame dumps, per-sequence association."""
    from ..evalutils.dvpq import list_frames
    from ..evalutils.stq import STQAccumulator

    pred_paths = list_frames(eval_dir, "pred")
    gt_paths = list_frames(eval_dir, "gt")
    acc = STQAccumulator()
    for pp, gp in zip(pred_paths, gt_paths):
        seq_id = int(os.path.basename(pp).split("_")[0])
        pred = np.load(pp)["panseg"].astype(np.int64)
        gt = np.load(gp)["panseg"].astype(np.int64)
        acc.update(pred, gt, seq_id=seq_id)
    return acc.result()


def run_inference(args) -> dict | None:
    """Decode, infer and dump every frame; returns the frame count, wall
    seconds (first frame in to last dump written) and mean dump-write ms."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ..data.cityscapes_dvps import INSTANCE_DIVISOR, CityscapesDVPSDataset
    from ..data.mp_loader import MPEvalLoader
    from ..data.pipeline import make_test_input
    from ..evalutils.dvpq import save_frame
    from ..infer.pipeline import make_clip_step, make_video_step
    from ..infer.tracker import init_tracker_state
    from ._cli import experiment, load_model, select_device

    dev = select_device(args.device)
    exp = experiment(args.preset, args.overrides, with_track=True)
    cfg, dc = exp.model, exp.data
    model = load_model(args.checkpoint, cfg, dev)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    ds = CityscapesDVPSDataset(args.data_root, split=args.split,
                               ref_sample_mode="img", with_depth=True)
    frames = ds.images if args.max_frames is None else ds.images[:args.max_frames]
    if args.num_shards > 1:
        # whole sequences per shard: the tracker state chain is sequential
        # within a sequence but sequences are independent
        frames = [f for f in frames
                  if f["seq_id"] % args.num_shards == args.shard_id]
    if not frames:
        return None

    # probe one frame for static shapes (val images share one size)
    probe = make_test_input(ds.load_frame(frames[0], segments=False), dc)
    ori_hw = probe["ori_hw"]
    padded_hw = probe["image"].shape[:2]
    t_clip = max(1, args.clip_len)
    on_card = dev.type == "cuda"

    def pack_outputs(sem, track, depth):
        """On the device: the panoptic id map sem * DIVISOR + track (int32)
        and depth on the Cityscapes-DVPS disk grid (meters * 256, uint16),
        half the bytes to copy back; ``--f32-depth`` keeps float32 meters.
        The grid values travel as the int16 of the same 16 bits."""
        pan = sem.to(torch.int32) * INSTANCE_DIVISOR + track.to(torch.int32)
        if args.f32_depth:
            return pan, depth.float()
        d16 = torch.clamp(torch.round(depth.float() * 256.0), 0, 65535)
        return pan, d16.to(torch.int32).to(torch.int16)

    def to_host(t):
        """Queue the copy of ``t`` into pinned host memory (no wait)."""
        if not on_card:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def save_pred(info, pan_h, dep_h, ovf_h, copied):
        if copied is not None:  # this clip's copies, not the next clip's work
            copied.synchronize()
        t0 = time.perf_counter()
        dep = dep_h.numpy()
        save_frame(args.eval_dir, "pred", info["seq_id"], info["img_id"],
                   pan_h.numpy().astype(np.int64),
                   dep.view(np.uint16) if dep.dtype == np.int16 else dep)
        ovf = int(ovf_h)
        msg = f"frame {info['seq_id']:06d}_{info['img_id']:06d} done"
        if ovf:
            msg += (f"  WARNING: {ovf} kept thing segment(s) beyond tracker "
                    f"capacity ({cfg.tracker.max_detections}) dropped to id 0")
        return msg, ovf, time.perf_counter() - t0

    make_step = make_video_step if t_clip == 1 else make_clip_step
    step = make_step(model, cfg, ori_hw, compute_dtype=dtype, fusion_dtype=dtype)

    def fresh_state():
        return init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)

    loader = MPEvalLoader(ds, frames, dc, padded_hw, num_workers=args.workers,
                          gt_dir=args.eval_dir, device=dev)
    state = fresh_state()
    prev_seq = None
    frames_in_seq = 0
    clip_infos: list = []
    clip_images: list = []
    saves: list = []
    total_overflow = 0
    write_s = []

    def flush_clip(pool) -> None:
        """Run the buffered clip and queue its per-frame pred writes."""
        nonlocal state
        if not clip_infos:
            return
        n_real = len(clip_infos)
        imgs = clip_images[:]
        while len(imgs) < t_clip:  # tail chunk: pad by repeating the last
            imgs.append(imgs[-1])  # frame; padded outputs are discarded
        first_id = frames_in_seq - n_real + 1
        if t_clip == 1:
            fo, state = step(imgs[0][None], state, first_id)
            pan, dep = pack_outputs(fo.semantic, fo.track_map, fo.depth)
            outs = [(pan, dep, fo.track_overflow)]
        else:
            co, state = step(torch.stack(imgs), state, first_id)
            pan, dep = pack_outputs(co.semantic, co.track_map, co.depth)
            outs = [(pan[j], dep[j], co.track_overflow[j]) for j in range(n_real)]
        host = [[to_host(t) for t in o] for o in outs]
        copied = None
        if on_card:
            copied = torch.cuda.Event()
            copied.record()
        for info, (p, d, o) in zip(clip_infos, host):
            saves.append(pool.submit(save_pred, info, p, d, o, copied))
        clip_infos.clear()
        clip_images.clear()

    def report(fut) -> None:
        nonlocal total_overflow
        msg, ovf, secs = fut.result()
        total_overflow += ovf
        write_s.append(secs)
        print(msg, flush=True)

    # the clock starts as the loader spawns its workers; the span is named
    # so that a profiler trace can take the device's busy time inside it
    t_enter = time.perf_counter()
    arrivals = []
    with torch.profiler.record_function("eval_video.inference"), loader, \
            ThreadPoolExecutor(max_workers=4) as pool:
        for info, image in loader:
            arrivals.append(time.perf_counter())
            if info["seq_id"] != prev_seq:
                # tracker reset at sequence start (video_inference.py:24-25)
                flush_clip(pool)
                state = fresh_state()
                prev_seq = info["seq_id"]
                frames_in_seq = 0
            clip_infos.append(info)
            clip_images.append(image)
            frames_in_seq += 1
            if len(clip_infos) == t_clip:
                flush_clip(pool)
            while saves and saves[0].done():
                report(saves.pop(0))
        flush_clip(pool)
        for fut in saves:
            report(fut)
        t_end = time.perf_counter()
    if total_overflow:
        print(f"tracker capacity overflow total: {total_overflow} segments "
              f"(raise tracker.max_detections)", flush=True)
    # steady rate: the first round of workers decodes in parallel while the
    # clock runs, so its frames and their time are left out
    n, w = len(frames), loader.num_workers
    wall = t_end - t_enter
    stats = {"frames": n, "wall_s": wall, "frames_per_s": n / wall,
             "first_frame_s": arrivals[0] - t_enter,
             "steady_frames_per_s": (n - w) / (t_end - arrivals[w - 1]) if n > w else None,
             "dump_write_ms": 1e3 * sum(write_s) / len(write_s)}
    print(f"inference: {n} frames in {wall:.2f} s from the loader's start "
          f"({stats['frames_per_s']:.2f} frames/s), pred dump "
          f"{stats['dump_write_ms']:.1f} ms a frame", flush=True)
    return stats


if __name__ == "__main__":
    main()
