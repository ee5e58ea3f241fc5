"""The port's training CLI on 2 gloo ranks, on the CPU.

``tools/train.py --preset debug_tiny_video`` over a 64x128 train split of
2 sequences x 2 frames (``repeat_times`` 1, a sample a rank a step) with a
3-frame val split, 2 steps, then a resumed run to step 4.  An epoch is
len(ds) x repeat // (batch x world) = 2 steps, so each run saves a
checkpoint and runs the sharded eval hook at its epoch's end.  Asserted:
rank 0 alone writes the metrics log (one file a run, a line a step) and
the checkpoints; the resumed run starts at step 2; both ranks hold the
same parameters at the end of each run, equal to those of rank 0's last
checkpoint; both ranks return the same eval metrics.
"""
import glob
import json
import os

import pytest

import torch

from polyphonicformer_torch.data.synthetic_split import write_dvps_split
from polyphonicformer_torch.train.checkpoint import state_digest
from tests.torch_dist_ranks import H, W, start_ranks

TIMEOUT = 200


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("cli")
    root, work = str(tmp / "data"), str(tmp / "work")
    write_dvps_split(root, "train", num_seqs=2, frames_per_seq=2, h=H, w=W)
    write_dvps_split(root, "val", num_seqs=1, frames_per_seq=3, h=H, w=W, seed=1)
    args = ["--preset", "debug_tiny_video", "--data-root", root, "--work-dir", work,
            "--device", "cpu", "--loader", "thread", "--eval-max-images", "3",
            "--set", f"data.img_size=({H},{W})"]
    first = start_ranks(tmp / "first", "train_cli", 2, TIMEOUT,
                        argv=args + ["--max-steps", "2"]).wait()
    logs = sorted(glob.glob(os.path.join(work, "*.metrics.jsonl")))
    resumed = start_ranks(tmp / "resumed", "train_cli", 2, TIMEOUT,
                          argv=args + ["--max-steps", "4", "--resume"]).wait()
    return {"first": first, "resumed": resumed, "work": work, "first_logs": logs}


def test_steps_per_epoch_divides_by_world(runs):
    for run in ("first", "resumed"):
        for r, s in enumerate(runs[run]):
            assert (s["rank"], s["world"]) == (r, 2)
            assert s["steps_per_epoch"] == 4 * 1 // (1 * 2)
    assert [s["start_step"] for s in runs["resumed"]] == [2, 2]
    assert [s["end_step"] for s in runs["resumed"]] == [4, 4]


def test_one_metrics_log_a_run(runs):
    assert len(runs["first_logs"]) == 1
    logs = sorted(glob.glob(os.path.join(runs["work"], "*.metrics.jsonl")))
    for run in ("first", "resumed"):
        r0, r1 = runs[run]
        assert r1["metrics_path"] is None and r0["metrics_path"] in logs
        assert r1["saves"] == [] and len(r0["saves"]) == 1
        with open(r0["metrics_path"]) as f:
            steps = [json.loads(line)["step"] for line in f]
        # a line a step (the two runs share a file when they start in one second)
        assert steps[:2] == [1, 2] if run == "first" else steps[-2:] == [3, 4]


def test_checkpoint_equals_every_rank(runs):
    for run in ("first", "resumed"):
        r0, r1 = runs[run]
        assert r0["state_digest"] == r1["state_digest"]
        ckpt = torch.load(r0["saves"][-1]["path"], weights_only=True)
        assert state_digest(ckpt["model"]) == r0["state_digest"]


def test_sharded_eval_hook_in_the_cli(runs):
    for run in ("first", "resumed"):
        r0, r1 = runs[run]
        assert len(r0["evals"]) == 1
        assert r0["evals"][0]["metrics"] == r1["evals"][0]["metrics"]
        assert r0["evals"][0]["metrics"]["depth_abs_rel"] > 0
