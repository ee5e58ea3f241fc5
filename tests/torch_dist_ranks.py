"""Gloo ranks for the port's distributed CPU tests (``test_torch_dist_*.py``).

:func:`start_ranks` starts ``world`` processes of this module; each sets 2
intra-op threads, joins the job through a FileStore in the test's
``tmp_path`` (never a port: the tests run in parallel), makes the mesh,
runs one of the ``rank_*`` functions below and saves what it returns.
:meth:`Ranks.wait` waits for all of them within the test's timeout,
kills every rank when one fails or the time is up, and returns the
results in rank order.  The ranks import torch and the port only; the
tests compare what they return with the JAX package in the test process,
which runs while the ranks do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128
SCHEDULE = dict(lr=5e-4, warmup_iters=1, warmup_ratio=1.0)


class Ranks:
    def __init__(self, procs, out_dir, timeout):
        self.procs, self.out_dir, self.deadline = procs, out_dir, time.time() + timeout

    def wait(self):
        import torch

        try:
            for r, p in enumerate(self.procs):
                out, _ = p.communicate(timeout=max(self.deadline - time.time(), 1))
                if p.returncode != 0:
                    raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-6000:]}")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]


def start_ranks(tmp_path, fn: str, world: int, timeout: float, **kwargs) -> Ranks:
    out_dir = str(tmp_path / f"ranks_{fn}")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", WORLD_SIZE=str(world),
               POLY_STORE_FILE=os.path.join(out_dir, "store"))  # as tools/launch.py sets
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_ranks", fn, out_dir, json.dumps(kwargs)],
        cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return Ranks(procs, out_dir, timeout)


def _experiment(name: str, **model):
    from polyphonicformer_torch.configs import preset

    exp = preset(name)
    return dataclasses.replace(exp, schedule=dataclasses.replace(exp.schedule, **SCHEDULE),
                               model=dataclasses.replace(exp.model, **model))


def rank_dp_step(mesh, video: bool, steps: int, batch: int):
    """Data-parallel train steps of ``debug_tiny`` (``video``: the 2-frame
    model) on the rank's part of ``synthetic_batch(batch, seed=0)``; the
    weights drawn from seed ``rank`` (rank 0's reach every rank)."""
    import torch

    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.parallel.mesh import local_slice
    from polyphonicformer_torch.train.step import create_train_state, make_sharded_train_step
    from polyphonicformer_torch.weights import to_numpy_state_dict

    exp = _experiment("debug_tiny_video" if video else "debug_tiny")
    model = build_model(exp.model, "cpu", generator=torch.Generator().manual_seed(mesh.rank))
    state, opt = create_train_state(model, exp, None, steps_per_epoch=1000, device="cpu")
    step = make_sharded_train_step(state.model, exp, opt, mesh, video=video)
    data = local_slice(synthetic_batch(exp.model, batch, (H, W), two_frame=video, seed=0,
                                       device="cpu"), mesh)
    metrics = []
    for _ in range(steps):
        state, m = step(state, data)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": to_numpy_state_dict(state.model)}


def tp_model_config():
    """The narrow swin_tiny model of ``tests/test_swin_sharding.py::_tp_cfg``
    with ``shard_backbone``."""
    from polyphonicformer_torch.configs import ModelConfig

    return ModelConfig(backbone="swin_tiny", out_channels=64, fpn_out_channels=64,
                       feedforward_channels=128, num_proposals=10, max_things=4,
                       remat_backbone=False, shard_backbone=True)


def rank_tp_step(mesh, state_dict: str, image: str, work_dir: str):
    """Tensor-parallel setup from the full ``state_dict`` file, the sharded
    backbone's forward of ``image`` (NCHW), one train step on
    ``synthetic_batch(1, seed=0)``, then a checkpoint (gathered to rank 0)
    restored into a fresh setup."""
    import torch

    from polyphonicformer_torch.configs import ExperimentConfig
    from polyphonicformer_torch.data.synthetic import synthetic_batch
    from polyphonicformer_torch.parallel.tensor_parallel import param_layout
    from polyphonicformer_torch.train.checkpoint import make_manager, restore_state, save_state
    from polyphonicformer_torch.train.step import make_tp_train_setup
    from polyphonicformer_torch.weights import to_numpy_state_dict

    exp = ExperimentConfig(model=tp_model_config())
    full = torch.load(state_dict)
    state, step, opt = make_tp_train_setup(exp, mesh, state_dict=full)
    with torch.no_grad():
        feats = [f.numpy() for f in state.model.backbone(torch.load(image))]
    state, m = step(state, synthetic_batch(exp.model, 1, (H, W), seed=0, device="cpu"))
    layout = param_layout(state.model)
    moments = {f"{opt.names[id(p)]}/{k}": opt.adamw.state[p][k].numpy().copy()
               for p in opt.params for k in ("exp_avg", "exp_avg_sq")}
    mgr = make_manager(work_dir)
    save_state(mgr, 1, state, opt, mesh)
    torch.distributed.barrier()
    state2, _, opt2 = make_tp_train_setup(exp, mesh, state_dict=full)
    state2 = restore_state(mgr, state2, opt2, mesh=mesh)
    restored = to_numpy_state_dict(state2.model)
    restored_moments = {f"{opt2.names[id(p)]}/{k}": opt2.adamw.state[p][k].numpy()
                        for p in opt2.params for k in ("exp_avg", "exp_avg_sq")}
    return {"metrics": {k: float(v) for k, v in m.items()}, "feats": feats,
            "params": to_numpy_state_dict(state.model), "moments": moments, "layout": layout,
            "restored": restored, "restored_moments": restored_moments,
            "restored_step": int(state2.step), "ckpt": mgr.file(1)}


def rank_serving(mesh, state_dict: str, clips: str, frame_ids: list):
    """The sharded batched serving step over the clips of ``clips`` ((T,
    B, H, W, 3), B = data ranks), frame t of clip b at ``frame_ids[t][b]``;
    per frame the gathered maps and this rank's tracker state."""
    import dataclasses as dc

    import torch

    from polyphonicformer_torch.configs import model_preset
    from polyphonicformer_torch.infer.pipeline import (gather_frame_outputs,
                                                       init_batched_tracker_states,
                                                       make_sharded_batched_video_step)
    from polyphonicformer_torch.models import build_model

    cfg = model_preset("debug_tiny_video", max_per_img=100)
    model = build_model(cfg, "cpu", state_dict=torch.load(state_dict))
    step = make_sharded_batched_video_step(model, cfg, (H, W), mesh)
    states = init_batched_tracker_states(cfg, 1, "cpu")
    frames = []
    for imgs, fids in zip(torch.load(clips), frame_ids):
        out, states = step(imgs, states, torch.tensor(fids, dtype=torch.int32))
        out = gather_frame_outputs(out, mesh)
        frames.append({"maps": {k: getattr(out, k).numpy() for k in
                                ("semantic", "panoptic", "track_map", "depth",
                                 "track_overflow")},
                       "state": {f.name: getattr(states, f.name).numpy()
                                 for f in dc.fields(states)}})
    return frames


def rank_eval(mesh, root: str, state_dict: str, missing_root: str, frames: int):
    """Sharded evaluation: the gathered statistics of ``dist_check``'s
    seeded frames, ``evaluate_frames(sharded=True)`` and the sharded eval
    hook over the first ``frames`` frames of the split at ``root``; then the
    hook with the split missing on rank 1 (``missing_root``)."""
    import numpy as np
    import torch

    from polyphonicformer_torch.configs import preset
    from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
    from polyphonicformer_torch.evalutils.runner import (allgather_frame_stats,
                                                         evaluate_frames, frame_stats,
                                                         make_eval_hook)
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.tools.dist_check import eval_frames

    stats = [frame_stats(*f) for f in eval_frames()[mesh.rank::mesh.world]]
    gathered = allgather_frame_stats(np.stack([s[0] for s in stats]),
                                     np.stack([s[1] for s in stats]), n_total=5)
    exp = preset("debug_tiny_video")
    model = build_model(exp.model, "cpu", state_dict=torch.load(state_dict))
    ds = CityscapesDVPSDataset(root, split="val", ref_sample_mode="img", with_depth=True)
    sharded = evaluate_frames(exp.model, exp.data, model, ds, ds.images[:frames], sharded=True)
    exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, data_root=root))
    hook = make_eval_hook(exp, lambda: model, max_images=frames, sharded=True)(1)
    bad = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, data_root=root if mesh.rank == 0 else missing_root))
    try:
        make_eval_hook(bad, lambda: model, max_images=frames, sharded=True)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return {"gathered": gathered, "sharded": sharded, "hook": hook, "raised": raised}


def rank_train_cli(mesh, argv: list):
    """``tools/train.py`` in this rank (the job is already joined)."""
    from polyphonicformer_torch.tools import train

    return train.main(argv)


def main(argv) -> None:
    if argv[0] == "fail_or_hang":  # under tools/launch.py: rank 1 fails, the others hang
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(600)
        return
    fn, out_dir, kwargs = argv
    import torch

    torch.set_num_threads(2)
    from polyphonicformer_torch.configs import ParallelConfig
    from polyphonicformer_torch.parallel.mesh import init_distributed, make_mesh

    kwargs = json.loads(kwargs)
    parallel = ParallelConfig(**kwargs.pop("parallel", {}))
    init_distributed("cpu", "gloo")
    result = globals()[f"rank_{fn}"](make_mesh(parallel, "cpu"), **kwargs)
    torch.save(result, os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
