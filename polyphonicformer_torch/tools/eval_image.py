"""Image-mode evaluation CLI: single-frame panoptic+depth inference and
PQ@lambda + depth metrics; the port of
``polyphonicformer_tpu/tools/eval_image.py``, with the same flags plus
``--device``.

    python -m polyphonicformer_torch.tools.eval_image --data-root DIR \\
        --checkpoint vars.pkl [--preset image_r50_2x] [--bf16] [--device cpu]

reference: tools/test.py + CityscapesDVPSDataset.evaluate
(datasets/cityscapes_dvps.py:350-443).  Runs on the CUDA card unless
``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    """Returns the metric dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--checkpoint", required=True, help="converted .pkl variables")
    ap.add_argument("--preset", default=None,
                    help="config preset (default: full R50 model)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 network and fusion (the K3 fusion kernel)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    from ..data.cityscapes_dvps import CityscapesDVPSDataset
    from ..evalutils.runner import evaluate_frames
    from ._cli import experiment, load_model, select_device

    dev = select_device(args.device)
    exp = experiment(args.preset)
    cfg, dc = exp.model, exp.data
    model = load_model(args.checkpoint, cfg, dev)

    ds = CityscapesDVPSDataset(args.data_root, split=args.split,
                               ref_sample_mode="img", with_depth=True)
    frames = ds.images if args.max_frames is None else ds.images[:args.max_frames]

    metrics = evaluate_frames(cfg, dc, model, ds, frames, verbose=True, bf16=args.bf16)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: (v if isinstance(v, float) else None)
                       for k, v in metrics.items()}, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
