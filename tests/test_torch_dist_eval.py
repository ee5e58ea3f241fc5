"""The port's sharded evaluation on 2 gloo ranks, on the CPU.

``allgather_frame_stats`` over ``tools/dist_check.py``'s 5 seeded frames
(3 + 2 a rank, the short shard padded with zero rows) against the JAX
package's ``frame_stats`` and ``metrics_from_stats`` over all 5;
``evaluate_frames(sharded=True)`` and ``make_eval_hook(sharded=True)``
over 5 frames of a 64x128 val split (seeded ``debug_tiny_video``, the last
``fc_cls`` bias 0) against the one-process ``evaluate_frames``: every
metric within 1e-7 (f64 sums in another order).  With the split missing
on rank 1 the sharded hook raises on both ranks (no rank is left waiting
in the gather).
"""
import numpy as np
import pytest

import torch

from polyphonicformer_tpu.evalutils.runner import frame_stats as jax_frame_stats
from polyphonicformer_tpu.evalutils.runner import metrics_from_stats as jax_metrics
from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.synthetic_split import write_dvps_split
from polyphonicformer_torch.evalutils.runner import evaluate_frames, metrics_from_stats
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools.dist_check import eval_frames
from tests.torch_dist_ranks import H, W, start_ranks

TIMEOUT, FRAMES = 200, 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("eval")
    root = str(tmp / "split")
    write_dvps_split(root, "val", num_seqs=2, frames_per_seq=3, h=H, w=W)
    exp = preset("debug_tiny_video")
    model = build_model(exp.model, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    torch.save(model.state_dict(), tmp / "weights.pt")
    ranks = start_ranks(tmp, "eval", 2, TIMEOUT, root=root, state_dict=str(tmp / "weights.pt"),
                        missing_root=str(tmp / "missing"), frames=FRAMES)
    ds = CityscapesDVPSDataset(root, split="val", ref_sample_mode="img", with_depth=True)
    one = evaluate_frames(exp.model, exp.data, model, ds, ds.images[:FRAMES])
    return ranks.wait(), one


def _close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) < 1e-7, (k, got[k], v)


def test_allgather_frame_stats_matches_jax(runs):
    ref = [jax_frame_stats(*f) for f in eval_frames()]
    want = jax_metrics(np.stack([s[0] for s in ref]), np.stack([s[1] for s in ref]))
    for rank in runs[0]:
        vpq, depth = rank["gathered"]
        assert vpq.shape[0] == depth.shape[0] == 6  # 2 x ceil(5 / 2) rows
        _close(metrics_from_stats(vpq, depth), want)
    assert want["pq@inf"] > 0


@pytest.mark.parametrize("key", ["sharded", "hook"])
def test_sharded_evaluation_matches_one_process(runs, key):
    ranks, one = runs
    for rank in ranks:
        _close({k: v for k, v in rank[key].items() if isinstance(v, float)},
               {k: v for k, v in one.items() if isinstance(v, float)})
    assert one["depth_abs_rel"] > 0  # random weights: every PQ is 0, the depth metrics not


def test_eval_hook_raises_on_every_rank_without_the_split(runs):
    for r, rank in enumerate(runs[0]):
        assert rank["raised"] is not None, f"rank {r} did not raise"
        assert "1/2 ranks" in rank["raised"], rank["raised"]
