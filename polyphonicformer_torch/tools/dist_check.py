"""Distributed-setup check of the port: init, a collective, one real
data-parallel train step of ``debug_tiny`` and the sharded evaluation's
statistics; with ``--legs`` also the data-parallel serving leg and the two
tensor-parallel Swin legs (a forward, a train step).  The counterpart of
``polyphonicformer_tpu/tools/dist_check.py`` and of the legs of
``__graft_entry__.py::dryrun_multichip``.

    python -m polyphonicformer_torch.tools.launch --nproc 2 --sim-cpu -- \\
        polyphonicformer_torch.tools.dist_check [--legs]

Every rank must print the same ``total_loss=`` and the same eval metrics.
Any failed check raises, and the launcher then stops every rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

HW = (64, 128)


def _train_leg(mesh, dev) -> float:
    """One data-parallel step, a sample a rank (seed = rank: distinct data)."""
    import torch

    from ..configs import preset
    from ..data.synthetic import synthetic_batch
    from ..models import build_model
    from ..train.step import create_train_state, make_sharded_train_step

    cfg = preset("debug_tiny")
    model = build_model(cfg.model, dev, generator=torch.Generator(dev).manual_seed(0))
    state, opt = create_train_state(model, cfg, None, device=dev)
    step = make_sharded_train_step(state.model, cfg, opt, mesh)
    state, metrics = step(state, synthetic_batch(cfg.model, 1, HW, seed=mesh.rank, device=dev))
    loss = float(metrics["total_loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"non-finite loss: {metrics}")
    return loss


def eval_frames(n: int = 5) -> list:
    """(pred_pan, gt_pan, pred_depth, gt_depth) of ``n`` seeded 16x24
    frames, the same on every rank."""
    import numpy as np

    rng = np.random.RandomState(0)
    frames = []
    for _ in range(n):
        gt_pan = rng.randint(0, 19, (16, 24)).astype(np.int64) * 10000
        pred_pan = gt_pan.copy()
        pred_pan[rng.rand(16, 24) < 0.2] = 3 * 10000
        gt_d = (rng.rand(16, 24) * 50 + 1).astype(np.float32)
        pred_d = gt_d * (1 + 0.1 * rng.randn(16, 24)).astype(np.float32)
        frames.append((pred_pan, gt_pan, pred_d, gt_d))
    return frames


def _eval_leg(rank: int, world: int) -> dict:
    """:func:`eval_frames`' statistics sharded over the ranks, gathered,
    against the one-process metrics (dist_check.py:257-289 of the JAX
    package)."""
    import numpy as np

    from ..evalutils.runner import allgather_frame_stats, frame_stats, metrics_from_stats

    frames = eval_frames()
    stats = [frame_stats(*f) for f in frames[rank::world]]
    vpq, depth = np.stack([s[0] for s in stats]), np.stack([s[1] for s in stats])
    vpq, depth = allgather_frame_stats(vpq, depth, n_total=len(frames))
    m = metrics_from_stats(vpq, depth)
    ref = [frame_stats(*f) for f in frames]
    m_ref = metrics_from_stats(np.stack([s[0] for s in ref]), np.stack([s[1] for s in ref]))
    for k in ("pq@inf", "pq@0.25", "depth_abs_rel", "depth_rmse"):
        if abs(m[k] - m_ref[k]) >= 1e-7:  # f64 sums in another order
            raise RuntimeError(f"sharded eval {k}: {m[k]} against {m_ref[k]}")
    return m


def _serving_leg(mesh, dev) -> str:
    """One clip a data rank through the sharded batched step, the outputs
    gathered in clip order, the DVPQ aggregation over them (every frame
    against itself: PQ 1 wherever a class is present)."""
    import numpy as np
    import torch

    from ..configs import model_preset
    from ..data.cityscapes_dvps import INSTANCE_DIVISOR
    from ..evalutils.vpq import aggregate_pq, vpq_eval
    from ..infer.pipeline import (gather_frame_outputs, init_batched_tracker_states,
                                  make_sharded_batched_video_step)
    from ..models import build_model

    cfg = model_preset("debug_tiny_video", max_per_img=20)
    model = build_model(cfg, dev, generator=torch.Generator(dev).manual_seed(0))
    with torch.no_grad():  # scores of 0.5: the seeded weights keep a segment
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    step = make_sharded_batched_video_step(model, cfg, HW, mesh)
    b = mesh.num_data
    images = torch.randn((b, *HW, 3), generator=torch.Generator(dev).manual_seed(1),
                         device=dev)
    states = init_batched_tracker_states(cfg, 1, dev)
    out, _ = step(images, states, torch.ones(b, dtype=torch.int32))
    out = gather_frame_outputs(out, mesh)
    pans = (out.semantic.cpu().numpy().astype(np.int64) * INSTANCE_DIVISOR
            + out.track_map.cpu().numpy().astype(np.int64))
    agg = aggregate_pq([vpq_eval(p, p) for p in pans], num_classes=19, num_things=8)
    present = agg["pq_per_class"] > 0
    if not present.any() or not np.allclose(agg["pq_per_class"][present], 1.0):
        raise RuntimeError(f"serving leg: pq self-check {agg['pq']}")
    return f"{b} clips over {mesh.num_data} data ranks, pq self-check {agg['pq']:.3f}"


def _tp_swin_leg(mesh, dev) -> str:
    """A Swin backbone sharded over the model axis against the same weights
    unsharded, on this rank."""
    import torch

    from ..models.swin import SwinTransformer
    from ..parallel.tensor_parallel import model_parallel
    from ..weights import shard_state_dict, swin_shard_specs

    spec = (32, (1, 1), (2, 4))
    full = SwinTransformer(*spec).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for p in full.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)
    tp = model_parallel(mesh)
    sharded = SwinTransformer(*spec, tp=tp).to(dev)
    sharded.load_state_dict(shard_state_dict(full.state_dict(), None, tp.index, tp.size,
                                             swin_shard_specs(*spec, prefix="")))
    x = torch.randn((1, 3, 28, 56), generator=gen, device=dev)
    with torch.no_grad():
        got, want = sharded(x), full(x)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err > 2e-5:
        raise RuntimeError(f"tensor-parallel Swin forward off by {err}")
    qkv = sharded.stages[0].blocks[0].attn.w_msa.qkv.weight
    return (f"mesh {mesh.num_data}x{mesh.num_model}, qkv shard {tuple(qkv.shape)}, "
            f"max err {err:.2e}")


def _tp_train_leg(mesh, dev) -> str:
    """One train step through model-sharded Swin parameters."""
    import torch

    from ..configs import preset
    from ..data.synthetic import synthetic_batch
    from ..train.step import make_tp_train_setup

    cfg = preset("debug_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone="swin_tiny", num_proposals=10, max_things=4,
        remat_backbone=False, shard_backbone=True))
    state, step, _ = make_tp_train_setup(cfg, mesh, torch.Generator(dev).manual_seed(0))
    batch = synthetic_batch(cfg.model, 1, HW, seed=mesh.data_index, device=dev)
    state, metrics = step(state, batch)
    loss = float(metrics["total_loss"])
    if loss != loss:
        raise RuntimeError(f"non-finite loss: {metrics}")
    qkv = state.model.backbone.stages[0].blocks[0].attn.w_msa.qkv.weight
    return f"loss={loss:.4f}, qkv shard {tuple(qkv.shape)} after the update"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", action="store_true",
                    help="also the data-parallel serving and the tensor-parallel Swin legs")
    ap.add_argument("--device", default=None,
                    help="default cuda, the rank's card (cpu under launch.py --sim-cpu)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..configs import ParallelConfig
    from ..parallel.mesh import all_reduce, init_distributed, make_mesh

    dev = init_distributed(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else "none"
    print(f"[rank {rank}/{world}] device {dev}, backend {backend}", flush=True)

    # wiring first, cheap: over every rank of the job, one rank too
    ones = all_reduce(torch.ones(4, device=dev), dist.group.WORLD if dist.is_initialized()
                      else None)
    if not torch.equal(ones, torch.full_like(ones, world)):
        raise RuntimeError(f"all_reduce gave {ones.tolist()}, expected {world}")
    print(f"[rank {rank}] all_reduce ok: {float(ones[0])}", flush=True)

    mesh = make_mesh(ParallelConfig(), dev)
    loss = _train_leg(mesh, dev)
    print(f"[rank {rank}] sharded train step ok: total_loss={loss:.6f}", flush=True)

    m = _eval_leg(rank, world)
    print(f"[rank {rank}] sharded eval stats ok: pq@inf={m['pq@inf']:.6f} "
          f"abs_rel={m['depth_abs_rel']:.6f}", flush=True)

    if args.legs:
        print(f"[rank {rank}] data-parallel serving ok: {_serving_leg(mesh, dev)}", flush=True)
        if world % 2:
            raise RuntimeError(f"the tensor-parallel legs need an even world, not {world}")
        tp_mesh = make_mesh(ParallelConfig(num_model=2), dev)
        print(f"[rank {rank}] tensor-parallel swin ok: {_tp_swin_leg(tp_mesh, dev)}",
              flush=True)
        print(f"[rank {rank}] tensor-parallel train ok: {_tp_train_leg(tp_mesh, dev)}",
              flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
