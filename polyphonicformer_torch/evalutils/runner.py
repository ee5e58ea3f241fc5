"""Image-mode evaluation runner and the training CLI's eval hook;
``polyphonicformer_tpu/evalutils/runner.py`` over the port's
``make_image_step``.

Sharded (``sharded=True``): each rank evaluates ``frames[rank::world]``
and the per-frame statistics, additive across frames, are gathered to
every rank (:func:`allgather_frame_stats`), so every rank returns the full
split's metrics; on one process that is the unsharded evaluation.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .dvpq import DEPTH_THRS
from .vpq import aggregate_pq, apply_depth_threshold, compute_depth_errors, vpq_eval

_DEPTH_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def frame_stats(pred_pan: np.ndarray, gt_pan: np.ndarray,
                pred_depth: np.ndarray, gt_depth: np.ndarray,
                num_classes: int = 19
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw per-frame stats, additive across frames/hosts.

    Returns (vpq (L, 4, num_classes+1) f64 — per depth-threshold iou/tp/fn/fp,
    depth (8,) f64 — the 7 depth metrics + a trailing valid flag)."""
    vpq = np.zeros((len(DEPTH_THRS), 4, num_classes + 1), np.float64)
    for li, thr in enumerate(DEPTH_THRS):
        pp = apply_depth_threshold(pred_pan, pred_depth, gt_depth, thr,
                                   num_classes)
        vpq[li] = np.stack(vpq_eval(pp, gt_pan, num_classes=num_classes))
    derr = compute_depth_errors(pred_depth, gt_depth)
    depth = np.asarray([derr[k] for k in _DEPTH_KEYS] + [1.0], np.float64)
    return vpq, depth


def metrics_from_stats(vpq_stats: np.ndarray, depth_stats: np.ndarray,
                       num_classes: int = 19, num_things: int = 8
                       ) -> Dict[str, float]:
    """(N, L, 4, C+1) + (N, 8) stat arrays -> the evaluate_image metric dict
    (reference: datasets/cityscapes_dvps.py:350-443)."""
    out: Dict[str, float] = {}
    w = depth_stats[:, -1]
    denom = max(w.sum(), 1.0)
    for i, k in enumerate(_DEPTH_KEYS):
        out[f"depth_{k}"] = float((depth_stats[:, i] * w).sum() / denom)
    for li, thr in enumerate(DEPTH_THRS):
        per_frame = [tuple(vpq_stats[n, li]) for n in range(vpq_stats.shape[0])]
        agg = aggregate_pq(per_frame, num_classes, num_things)
        key = "inf" if thr == 0 else str(thr)
        out[f"pq@{key}"] = agg["pq"]
        out[f"pq_thing@{key}"] = agg["pq_thing"]
        out[f"pq_stuff@{key}"] = agg["pq_stuff"]
    out["PQ_all"] = out["pq@inf"]
    return out


def _infer_frame_stats(model_cfg, data_cfg, model, ds, infos, bf16: bool,
                       verbose: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Inference on ``model``'s device + per-frame stats over ``infos``."""
    import torch

    from ..data.cityscapes_dvps import INSTANCE_DIVISOR
    from ..data.pipeline import make_test_input
    from ..infer.pipeline import make_image_step

    dev = next(model.parameters()).device
    dt = torch.bfloat16 if bf16 else torch.float32
    vpqs: List[np.ndarray] = []
    depths: List[np.ndarray] = []
    step = None
    for info in infos:
        frame = ds.load_frame(info, segments=False)
        inp = make_test_input(frame, data_cfg)
        if step is None:
            step = make_image_step(model, model_cfg, inp["ori_hw"], compute_dtype=dt,
                                   fusion_dtype=dt)
        res = step(torch.from_numpy(inp["image"])[None].to(dev))
        sem = res.semantic.cpu().numpy().astype(np.int64)
        pan = res.panoptic.cpu().numpy().astype(np.int64)
        seg_ids = res.seg_ids.cpu().numpy()
        keep = res.keep.cpu().numpy()
        is_thing_seg = np.zeros(int(seg_ids.max()) + 2, bool)
        for sid, th in zip(seg_ids[keep], res.is_thing.cpu().numpy()[keep]):
            is_thing_seg[sid] = th
        inst = np.where(is_thing_seg[pan], pan, 0)
        pred_pan = sem * INSTANCE_DIVISOR + inst
        v, d = frame_stats(pred_pan, frame["pan"], res.depth.cpu().numpy(),
                           frame["depth"])
        vpqs.append(v)
        depths.append(d)
        if verbose:
            print(f"frame {info['seq_id']:06d}_{info['img_id']:06d} done",
                  flush=True)
    lthr, nc1 = len(DEPTH_THRS), 20
    if not vpqs:
        return (np.zeros((0, lthr, 4, nc1)), np.zeros((0, 8)))
    return np.stack(vpqs), np.stack(depths)


def _world():
    """(group, rank, world) of every rank; (None, 0, 1) on one process."""
    import torch.distributed as dist

    from ..parallel.mesh import world_group

    group = world_group()
    return (group, 0, 1) if group is None else (group, dist.get_rank(), dist.get_world_size())


def allgather_frame_stats(vpq_stats: np.ndarray, depth_stats: np.ndarray,
                          n_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ranks' frame-statistic shards gathered into the full-split
    arrays on every rank, in rank order (mmdet collect_results_cpu).  Each
    shard is padded to ceil(n_total / world) rows with zero rows: zero vpq
    statistics add nothing and a zero depth valid flag drops the row from
    the weighted mean."""
    import torch

    from ..parallel.mesh import all_gather

    group, _, world = _world()
    per = -(-n_total // world)
    pad = per - vpq_stats.shape[0]
    if pad:
        vpq_stats = np.concatenate([vpq_stats, np.zeros((pad,) + vpq_stats.shape[1:])])
        depth_stats = np.concatenate([depth_stats, np.zeros((pad, depth_stats.shape[1]))])
    vpq_all = all_gather(torch.from_numpy(np.ascontiguousarray(vpq_stats, np.float64)), group)
    depth_all = all_gather(torch.from_numpy(np.ascontiguousarray(depth_stats, np.float64)),
                           group)
    return (vpq_all.numpy().reshape((-1,) + vpq_stats.shape[1:]),
            depth_all.numpy().reshape((-1, depth_stats.shape[1])))


def evaluate_frames(model_cfg, data_cfg, model, ds, frames, verbose: bool = False,
                    bf16: bool = False, sharded: bool = False) -> Dict[str, float]:
    """Run single-frame panoptic+depth inference with ``model`` (on its own
    device) over ``frames`` and compute image PQ + depth metrics
    (CityscapesDVPSDataset.evaluate equivalent).  ``sharded``: this rank
    infers ``frames[rank::world]`` and every rank returns the metrics of
    all of ``frames``."""
    _, rank, world = _world()
    mine = list(frames)[rank::world] if sharded else frames
    vpq_stats, depth_stats = _infer_frame_stats(
        model_cfg, data_cfg, model, ds, mine, bf16, verbose)
    if sharded:
        vpq_stats, depth_stats = allgather_frame_stats(vpq_stats, depth_stats, len(frames))
    return metrics_from_stats(vpq_stats, depth_stats)


def make_eval_hook(cfg, model_fn: Callable, max_images: Optional[int] = 50,
                   sharded: bool = False):
    """``hook(step) -> dict`` of :func:`evaluate_frames` (f32) on
    ``model_fn()`` over the first ``max_images`` frames of the val split
    (None or 0: all of them; reference EvalHook,
    mmdet/apis/train.py:183-204), or None, with the reason printed, when
    the split is absent or empty.  ``sharded``: :func:`evaluate_frames`
    sharded over the job's ranks, which first agree that each of them has
    the split: when only some have it, every rank raises (the others would
    wait for them in the gather forever)."""
    from ..data.cityscapes_dvps import CityscapesDVPSDataset

    try:
        ds = CityscapesDVPSDataset(cfg.data.data_root, split="val", ref_sample_mode="img",
                                   with_depth=True)
        err = None
    except FileNotFoundError as e:  # val split not on disk
        ds, err = None, e
    frames = [] if ds is None else (ds.images if not max_images else ds.images[:max_images])
    group, rank, world = _world()
    if sharded:
        import torch

        from ..parallel.mesh import all_gather

        ok = all_gather(torch.tensor([1 if frames else 0], dtype=torch.int32), group)
        if ok.min() != ok.max():
            raise RuntimeError(
                f"val split visible on only {int(ok.sum())}/{world} ranks (rank {rank}: "
                f"{'ok' if frames else err}); put the dataset on every host or set "
                "--eval-every-epochs 0")
    if err is not None:
        print(f"eval hook disabled ({err})")
        return None
    if not frames:
        print("eval hook disabled (empty val split)")
        return None

    def hook(step: int) -> Dict[str, float]:
        metrics = evaluate_frames(cfg.model, cfg.data, model_fn(), ds, frames, sharded=sharded)
        flat = {k: v for k, v in metrics.items() if isinstance(v, float)}
        if rank == 0:
            summary = " ".join(f"{k}={v:.4f}" for k, v in sorted(flat.items()) if k in (
                "pq@inf", "pq_thing@inf", "pq_stuff@inf", "depth_abs_rel"))
            print(f"[eval @ step {step}] {summary} ({len(frames)} frames)", flush=True)
        return flat

    return hook
