"""Training CLI on one card or several data-parallel ranks; the port of
``polyphonicformer_tpu/tools/train.py``, with the same flags plus
``--device``.

    python -m polyphonicformer_torch.tools.train --preset video_r50_1x \\
        --data-root /data/cityscapes-dvps [--load-from vars.pkl] [--resume] \\
        [--set data.batch_size=2 schedule.lr=2e-4 ...] [--device cpu]

reference: tools/train.py + mmdet train_detector (mmdet/apis/train.py).
``cfg.data.batch_size`` samples a step from the train split through the
worker-process loader (``--loader process``) or the thread loader; the
step is ``train/step.py::make_sharded_train_step`` (on one process the
plain ``make_train_step``; ``video=True`` for a preset with the track
head).  Every ``schedule.log_interval`` steps a line of
metrics goes to ``work_dir/<time>.metrics.jsonl`` and stdout, with
``samples_per_sec`` and ``eta_min``; metric tensors are read back to the
host only on those steps.  Every ``schedule.checkpoint_interval`` epochs
and at the last step a checkpoint goes to
``work_dir/checkpoints/<step>.pt`` (the newest
``schedule.max_keep_checkpoints`` kept); ``--resume`` continues from the
latest.  Every ``--eval-every-epochs`` epochs the val split, when it is on
disk, is evaluated (image PQ and depth).  Runs on the CUDA card unless
``--device cpu``; with no card it raises.

Several ranks (``tools/launch.py --nproc N`` or ``torchrun``): each rank
takes ``cfg.data.batch_size`` samples a step from its own loader (seed
``--seed + 1000 x rank``), the step sums the gradients over the data
axis, an epoch is ``len(ds) * repeat_times // (batch_size x
world)`` steps, ``samples_per_sec`` counts the global batch, rank 0 alone
writes the metrics and the checkpoints, and the eval hook is sharded over
the ranks.  ``--device cuda`` is the rank's card.  Tensor-parallel Swin
(``train/step.py::make_tp_train_setup``) is a library path, not this CLI's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> dict:
    """Returns a summary: the steps run, the rank and world, the metric file
    (None but on rank 0), the checkpoints written, the final parameters'
    ``state_digest``, each step's host wall (the loader's batch, then the queued
    step; no save or evaluation), the part of it spent in the loader (its
    transfer included) and the part of that spent waiting for samples, the
    save and restore seconds and the evaluations."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="image_r50_2x")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--load-from", default=None,
                    help="converted .pkl variables to warm-start from")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loader", choices=("process", "thread"), default="process",
                    help="host pipeline backend: worker processes (shared-memory ring; the "
                         "reference's DataLoader-worker equivalent) or GIL-bound threads "
                         "(debug)")
    ap.add_argument("--eval-every-epochs", type=int, default=1,
                    help="run PQ/depth eval on the val split every N epochs (0 disables; "
                         "reference EvalHook interval 1)")
    ap.add_argument("--eval-max-images", type=int, default=50,
                    help="0 = the full val split")
    ap.add_argument("--set", nargs="*", dest="overrides",
                    help="dotted-path config overrides key=value")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default cuda, the rank's card; cpu on "
                         "request or under tools/launch.py --sim-cpu)")
    args = ap.parse_args(argv)

    import torch

    from ..data.cityscapes_dvps import CityscapesDVPSDataset
    from ..models import PolyphonicFormer
    from ..parallel.mesh import init_distributed, make_mesh
    from ..train.checkpoint import (latest_step, make_manager, restore_state, save_state,
                                    state_digest)
    from ..train.metrics import MetricWriter
    from ..train.step import create_train_state, make_sharded_train_step
    from ._cli import experiment, load_model, select_device

    dev = select_device(str(init_distributed(args.device)))  # no-op outside a launched job
    cfg = experiment(args.preset)
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                data_root=args.data_root))
    if args.work_dir:
        cfg = dataclasses.replace(cfg, work_dir=args.work_dir)
    if args.overrides:
        from ..configs import apply_overrides, parse_overrides

        cfg = apply_overrides(cfg, parse_overrides(args.overrides))

    if cfg.parallel.num_model != 1:
        raise ValueError("the training CLI is data-parallel (parallel.num_model=1); "
                         "tensor-parallel Swin is train/step.py::make_tp_train_setup")
    mesh = make_mesh(cfg.parallel, dev)
    rank, world = mesh.rank, mesh.world

    video = cfg.model.with_track
    ds = CityscapesDVPSDataset(cfg.data.data_root, split=cfg.data.split,
                               ref_sample_mode=cfg.data.ref_sample_mode,
                               ref_seq_index=cfg.data.ref_seq_index, with_depth=True)
    if args.loader == "process":
        from ..data.mp_loader import MPTrainLoader as Loader
    else:
        from ..data.loader import TrainLoader as Loader
    loader = Loader(ds, cfg.data, cfg.model, seed=args.seed + 1000 * rank, device=dev)

    # cfg.data.batch_size is a rank's batch (the reference's samples_per_gpu);
    # the schedule and the intervals count steps of len(ds) * repeat_times
    # samples an epoch over the global batch
    global_batch = cfg.data.batch_size * world
    steps_per_epoch = max(len(ds) * cfg.data.repeat_times // global_batch, 1)
    total_steps = args.max_steps or steps_per_epoch * cfg.schedule.total_epochs

    if args.load_from:
        model, gen = load_model(args.load_from, cfg.model, dev), None
        print(f"warm-started from {args.load_from}")
    else:
        with torch.device("meta"):
            model = PolyphonicFormer(cfg.model)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
    state, opt = create_train_state(model, cfg, gen, steps_per_epoch, device=dev)

    mgr = make_manager(cfg.work_dir, cfg.schedule.max_keep_checkpoints)
    restore_s = None
    if args.resume and latest_step(mgr) is not None:
        t0 = time.perf_counter()
        state = restore_state(mgr, state, opt)
        restore_s = time.perf_counter() - t0
        print(f"resumed from step {int(state.step)}")

    step_fn = make_sharded_train_step(state.model, cfg, opt, mesh, video=video)
    writer = MetricWriter(cfg.work_dir, cfg.schedule.log_interval) if rank == 0 else None

    # periodic eval during training (reference EvalHook,
    # mmdet/apis/train.py:183-204); disabled when there is no val split
    eval_hook = None
    if args.eval_every_epochs > 0:
        from ..evalutils.runner import make_eval_hook

        eval_hook = make_eval_hook(cfg, lambda: state.model, max_images=args.eval_max_images,
                                   sharded=True)
    eval_every = steps_per_epoch * max(args.eval_every_epochs, 1)
    ckpt_every = steps_per_epoch * cfg.schedule.checkpoint_interval

    start = int(state.step)
    summary = {"start_step": start, "total_steps": total_steps, "rank": rank, "world": world,
               "steps_per_epoch": steps_per_epoch,
               "metrics_path": None if writer is None else writer.path,
               "step_wall_s": [], "loader_s": [], "sample_wait_s": [], "saves": [],
               "restore_s": restore_s, "evals": []}
    it = iter(loader)
    t_log = time.perf_counter()
    samples_done = 0
    try:
        for step_idx in range(start, total_steps):
            with torch.profiler.record_function("train.step"):
                t0, waited = time.perf_counter(), loader.sample_wait_s
                batch = next(it)
                summary["loader_s"].append(time.perf_counter() - t0)
                summary["sample_wait_s"].append(loader.sample_wait_s - waited)
                state, metrics = step_fn(state, batch)
                summary["step_wall_s"].append(time.perf_counter() - t0)
            samples_done += global_batch
            if writer is not None and writer.due(step_idx + 1):
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                dt = time.perf_counter() - t_log
                steps_left = total_steps - (step_idx + 1)
                metrics["samples_per_sec"] = samples_done / max(dt, 1e-9)
                metrics["eta_min"] = steps_left * (dt / cfg.schedule.log_interval) / 60
                t_log = time.perf_counter()
                samples_done = 0
            if writer is not None:
                writer.write(step_idx + 1, metrics)
            if rank == 0 and (
                    (step_idx + 1) % ckpt_every == 0 or step_idx + 1 == total_steps):
                t0 = time.perf_counter()
                path = save_state(mgr, step_idx + 1, state, opt)
                summary["saves"].append({"step": step_idx + 1, "path": path,
                                         "s": time.perf_counter() - t0})
            if eval_hook is not None and (step_idx + 1) % eval_every == 0:
                t0 = time.perf_counter()
                result = eval_hook(step_idx + 1)
                summary["evals"].append({"step": step_idx + 1, "metrics": result,
                                         "s": time.perf_counter() - t0})
    finally:
        loader.stop()
        if writer is not None:
            writer.close()
    if world > 1:  # rank 0's last checkpoint is on disk before any rank moves on
        torch.distributed.barrier()
    summary["end_step"] = int(state.step)
    summary["state_digest"] = state_digest(state.model.state_dict())
    print("training done")
    return summary


if __name__ == "__main__":
    main()
