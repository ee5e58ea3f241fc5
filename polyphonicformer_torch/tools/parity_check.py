"""One-command checkpoint-parity runbook; the port of
``polyphonicformer_tpu/tools/parity_check.py``, with the same flags,
measured keys, ``parity.json``, tolerances and exit codes, plus
``--device``.

The reference's published checkpoints (``polyphonic_r50_image.pth`` /
``polyphonic_r50_video.pth``) are not in the repository, so the values of
the gates stay uncomputed until they are supplied:

  python -m polyphonicformer_torch.tools.parity_check \\
      --image-pth polyphonic_r50_image.pth \\
      --video-pth polyphonic_r50_video.pth \\
      --data-root /data/cityscapes_dvps \\
      --expected pq@inf=0.655 depth_abs_rel=0.084 dvpq_average=58.1 [--device cpu]

Stages (each skipped when its inputs are omitted):
  1. convert: the ``.pth`` -> the JAX CLIs' ``.pkl`` of variables, with the
     port's ``tools/convert_torch_ckpt.py`` (no JAX);
  2. image eval: PQ@lambda + depth metrics over the split
     (``evalutils/runner.py::evaluate_frames``, as ``tools/eval_image.py``);
  3. video eval: ``tools/eval_video.py::run_inference`` (clip steps, raw
     f32 depth dumps) + DVPQ over the 16 (k, lambda) cells;
  4. gates: measured against ``--expected`` within ``--tol-dvpq`` /
     ``--tol-absrel`` / ``--tol-pq``; exit code 1 if any gate fails, else 0.

Without ``--expected`` the tool prints the measured table and reports the
gates UNVERIFIED.  Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import Dict, Optional


def convert_checkpoint(pth_path: str, out_pkl: str, video: bool,
                       backbone: str = "resnet50", allow_unsafe: bool = False) -> str:
    """Stage 1: a ``.pth`` file -> the converted variables' ``.pkl``."""
    from ..configs import ModelConfig
    from .convert_torch_ckpt import convert_state_dict, load_torch_state_dict

    sd = load_torch_state_dict(pth_path, allow_unsafe=allow_unsafe)
    variables = convert_state_dict(sd, ModelConfig(with_track=video, backbone=backbone))
    os.makedirs(os.path.dirname(out_pkl) or ".", exist_ok=True)
    with open(out_pkl, "wb") as f:
        pickle.dump(variables, f)
    print(f"[convert] {pth_path} -> {out_pkl} ({len(sd)} torch tensors)")
    return out_pkl


def run_image_eval(ckpt_pkl: str, data_root: str, split: str, max_frames: Optional[int],
                   bf16: bool, preset: Optional[str], device: str = "cuda") -> Dict[str, float]:
    """Stage 2: image-mode PQ@lambda + depth metrics."""
    from ..data.cityscapes_dvps import CityscapesDVPSDataset
    from ..evalutils.runner import evaluate_frames
    from ._cli import experiment, load_model, select_device

    dev = select_device(device)
    exp = experiment(preset)
    model = load_model(ckpt_pkl, exp.model, dev)
    ds = CityscapesDVPSDataset(data_root, split=split, ref_sample_mode="img", with_depth=True)
    frames = ds.images if max_frames is None else ds.images[:max_frames]
    metrics = evaluate_frames(exp.model, exp.data, model, ds, frames, verbose=True, bf16=bf16)
    return {k: v for k, v in metrics.items() if isinstance(v, float)}


def run_video_eval(ckpt_pkl: str, data_root: str, split: str, max_frames: Optional[int],
                   bf16: bool, preset: Optional[str], eval_dir: str, clip_len: int,
                   workers: int, nproc: int, device: str = "cuda") -> Dict[str, float]:
    """Stage 3: video inference + DVPQ aggregation."""
    from ..evalutils.dvpq import evaluate_dvpq
    from ..ops import native
    from .eval_video import run_inference

    native.load()  # build the host library once, before any worker needs it
    ns = argparse.Namespace(
        data_root=data_root, split=split, checkpoint=ckpt_pkl, preset=preset,
        eval_dir=eval_dir, nproc=nproc, max_frames=max_frames, bf16=bf16,
        shard_id=0, num_shards=1, overrides=None, clip_len=clip_len,
        workers=workers, f32_depth=True, device=device)  # strict reference-format dumps
    run_inference(ns)
    results = evaluate_dvpq(eval_dir, nproc=nproc)
    flat: Dict[str, float] = {}
    for cell, vals in results.items():
        for name, v in vals.items():
            flat[f"dvpq_{cell}" if name == "pq" else f"dvpq_{cell}_{name[3:]}"] = v
    flat["dvpq_average"] = results["average"]["pq"]
    return flat


def check_gates(measured: Dict[str, float], expected: Dict[str, float],
                tol_dvpq: float, tol_pq: float, tol_absrel: float) -> bool:
    """Stage 4: DVPQ within tol_dvpq (absolute points), PQ within tol_pq,
    depth absRel within tol_absrel; prints a PASS or FAIL line per gate."""
    if not expected:
        print("[gates] UNVERIFIED: no --expected values supplied; record the "
              "reference eval's numbers and re-run")
        return True
    ok = True
    for key, want in expected.items():
        if key not in measured:
            print(f"[gates] FAIL {key}: expected {want} but not measured "
                  f"(keys: {sorted(measured)[:8]}...)")
            ok = False
            continue
        got = measured[key]
        tol = (tol_absrel if "abs_rel" in key
               else tol_dvpq if key.startswith("dvpq") else tol_pq)
        status = "PASS" if abs(got - want) <= tol else "FAIL"
        if status == "FAIL":
            ok = False
        print(f"[gates] {status} {key}: measured {got:.4f} vs expected "
              f"{want:.4f} (tol {tol})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--image-pth", help="published image checkpoint (.pth)")
    ap.add_argument("--video-pth", help="published video checkpoint (.pth)")
    ap.add_argument("--data-root", help="Cityscapes-DVPS root (omit to only convert)")
    ap.add_argument("--split", default="val")
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--preset-image", default=None)
    ap.add_argument("--preset-video", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--unsafe-load", action="store_true",
                    help="permit full-unpickle torch.load fallback "
                         "(arbitrary code execution on a tampered file)")
    ap.add_argument("--workdir", default="work_dirs/parity_check")
    ap.add_argument("--clip-len", type=int, default=6)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--nproc", type=int, default=8)
    ap.add_argument("--expected", nargs="*", default=[],
                    help="key=value gates, e.g. pq@inf=0.655 "
                    "depth_abs_rel=0.084 dvpq_average=58.1")
    ap.add_argument("--tol-dvpq", type=float, default=0.1,
                    help="BASELINE gate: DVPQ within 0.1 points")
    ap.add_argument("--tol-pq", type=float, default=0.001)
    ap.add_argument("--tol-absrel", type=float, default=0.002,
                    help="BASELINE gate: depth absRel parity")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    expected = {}
    for kv in args.expected:
        k, _, v = kv.partition("=")
        expected[k] = float(v)

    measured: Dict[str, float] = {}
    if args.image_pth:
        image_pkl = os.path.join(args.workdir, "image_vars.pkl")
        convert_checkpoint(args.image_pth, image_pkl, video=False, backbone=args.backbone,
                           allow_unsafe=args.unsafe_load)
        if args.data_root:
            measured.update(run_image_eval(
                image_pkl, args.data_root, args.split, args.max_frames, args.bf16,
                args.preset_image, args.device))
    if args.video_pth:
        video_pkl = os.path.join(args.workdir, "video_vars.pkl")
        convert_checkpoint(args.video_pth, video_pkl, video=True, backbone=args.backbone,
                           allow_unsafe=args.unsafe_load)
        if args.data_root:
            measured.update(run_video_eval(
                video_pkl, args.data_root, args.split, args.max_frames, args.bf16,
                args.preset_video, os.path.join(args.workdir, "video_eval"), args.clip_len,
                args.workers, args.nproc, args.device))

    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "parity.json"), "w") as f:
        json.dump(measured, f, indent=2)
    for k in sorted(measured):
        print(f"[measured] {k}: {measured[k]:.4f}")

    ok = check_gates(measured, expected, args.tol_dvpq, args.tol_pq, args.tol_absrel)
    print(f"[parity_check] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
