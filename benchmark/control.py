"""Readings that set the limits of ``correct`` (``benchmark/limits``).

    python -m benchmark.control --workload <name> --seeds <n> [<n> ...]
        [--seconds <s>] [--program 0|1] [--control 0|1] [--fault matching]

For each seed, in one process: the program's compared numbers from a short
window at the cell's own load (``--program 1``), and the control's, the
reference put in the program's place and computed in the precision below
the configuration's (``--control 1``): TF32 for an f32 configuration,
float8 for a bf16 one.  ``--fault matching`` plants a fault in the
program's runs: its Hungarian answers altered where they are produced.
One JSON line a seed and kind on standard output.  The benchmark's own
runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import cells, weights
from .run import Context, run_cell


def lower_precision(dtype: str) -> str:
    return "tf32" if dtype == "float32" else "fp8"


def control_train(cell, seed: int, dev) -> dict:
    from .check import train as check
    from .reference import config as ref_config
    from .traffic import synthetic_batch

    exp = ref_config.experiment(cell.config)
    sd = weights.state_dict(exp, seed, dev)
    parts = synthetic_batch.pool(cell.mix, exp.model, int(cell.config["batch_size"]),
                                 tuple(cell.config["image_hw"]), seed, dev)
    n, spe = int(cell.mix["reference_steps"]), int(cell.mix["steps_per_epoch"])
    low = lower_precision(cell.config["train"]["compute_dtype"])
    ctl = check.reference_readings(exp, sd, parts, n, dev, spe, precision=low)
    ref = check.reference_readings(exp, sd, parts, n, dev, spe, force=ctl["matchings"])
    return {k: v[0] for k, v in check.gaps(ctl, ref).items()} | {"precision": low}


def control_serve(cell, seed: int, dev) -> dict:
    import torch

    from .check import serve as check
    from .entries.serve_batched import check_steps
    from .reference import config as ref_config
    from .traffic import moving_blocks

    exp = ref_config.experiment(cell.config)
    mix = cell.mix
    dtype = getattr(torch, cell.config["serve"]["compute_dtype"])
    sd = weights.state_dict(exp, seed, dev, zero_class_bias=bool(mix["zero_class_bias"]))
    frames = moving_blocks.pool(mix, tuple(cell.config["image_hw"]), seed, dev)
    ref = check.reference_network(exp, sd, dev, dtype)
    ctl = check.reference_network(exp, sd, dev, dtype, precision="fp8")
    hw = tuple(cell.config["image_hw"])
    fusion = getattr(torch, cell.config["serve"]["fusion_dtype"])
    worst = {}
    for t in check_steps(mix, seed):
        fr, r = check.network_outputs(ref, frames[t % frames.shape[0]], dtype)
        fc, c = check.network_outputs(ctl, frames[t % frames.shape[0]], dtype)
        gaps = check.network_gaps(ref, c, r, dev)
        valid, boxes = check.detections(exp, r, hw, dev, fusion)
        with torch.no_grad():
            emb = check.embeds_gap(ctl.forward_track_embeds(fc, None, valid, boxes=boxes),
                                   ref.forward_track_embeds(fr, None, valid, boxes=boxes),
                                   valid)
        if emb is not None:  # no detections: no number
            gaps["embeds_rel_err"] = emb
        gaps["detections"] = float(valid.sum())
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst | {"precision": "fp8"}


class _AlteredMatching:
    """A planted fault: the program's Hungarian answer altered where it is
    produced, every assigned column moved to the next prediction."""

    def __init__(self, solve):
        self.solve = solve

    def __call__(self, costs, valid):
        return next_column(self.solve(costs, valid), costs.shape[-1])


def next_column(cols, p: int):
    """Each assigned column moved to the next of ``p`` (a permutation, so
    still an assignment); unassigned rows (-1) stay."""
    return (cols + 1).remainder(p).where(cols >= 0, cols)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--fault", choices=("matching",), default=None,
                    help="plant a fault in the program's runs")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    kind = "serve" if "streams" in cell.mix else "train"
    if kind == "serve":  # kept steps that a short window reaches
        cell.mix = dict(cell.mix, check_sample_below=int(cell.mix["check_first_steps"]) + 8)
    if args.fault == "matching":
        from polyphonicformer_torch.ops import hungarian

        hungarian.solve_lsa = _AlteredMatching(hungarian.solve_lsa)
    for seed in args.seeds:
        if args.program:
            res = run_cell(Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                                   device=dev, started=time.time()))
            print(json.dumps({"seed": seed, "side": "program", "fault": args.fault,
                              **{n: v for n, v, _ in res.checks}, "notes": res.notes}),
                  flush=True)
            torch.cuda.empty_cache()
        if args.control:
            out = (control_serve if kind == "serve" else control_train)(cell, seed, dev)
            print(json.dumps({"seed": seed, "side": "control", **out}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
