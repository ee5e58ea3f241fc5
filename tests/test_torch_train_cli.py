"""The port's training CLI (``polyphonicformer_torch/tools/train.py``) as a
whole on the CPU, against the JAX package's ``tools/train.py``.

Both CLIs train ``debug_tiny`` for 2 steps from the same
``write_dvps_split(split="train")`` split (128x256 PNGs), the same seed and
the same ``--load-from`` pickle (seeded port weights bridged to JAX
variables: the JAX CLIs' format), through their thread loaders, which give
the same batches (``tests/test_torch_train_loader.py``).  Their metric
JSONL lines agree: step 1's loss dict within rtol 1e-4 and step 2's
``total_loss`` within rtol 1e-3 (``tests/test_torch_train_step.py``'s
tolerances), each plus atol 1e-6, the 6-decimal rounding of both writers.
``grad_norm`` is left out: the port's counts only the trainable gradients
(a deliberate difference, ROADMAP section 3).

On a one-frame split with no flip and ratio 1 every batch is the same
(and a checkpoint is saved only at a run's last step), so a run of 2 steps
resumed to 3 (``--resume``) must end where 3 uninterrupted
steps end: step count, parameters, optimizer state and learning rate equal
bit for bit; its last checkpoint restores.  A run with a val split fires
the eval hook at the end of its epoch, and the hook's metrics equal
``evaluate_frames`` on the checkpoint's weights (exactly).
"""
import dataclasses
import glob
import json
import math
import os
import pickle
import sys
from unittest import mock

import pytest
import torch

from polyphonicformer_tpu.configs import get_preset as jax_preset
from polyphonicformer_tpu.tools import train as jax_train
from polyphonicformer_torch.configs import model_preset, preset
from polyphonicformer_torch.data.cityscapes_dvps import CityscapesDVPSDataset
from polyphonicformer_torch.data.synthetic_split import write_dvps_split
from polyphonicformer_torch.evalutils.runner import evaluate_frames, make_eval_hook
from polyphonicformer_torch.models import PolyphonicFormer, build_model
from polyphonicformer_torch.tools import train
from polyphonicformer_torch.train.checkpoint import make_manager, restore_state
from polyphonicformer_torch.train.step import create_train_state
from polyphonicformer_torch.weights import to_jax_variables, to_numpy_state_dict

H, W = 128, 256
NOT_LOSSES = ("step", "time", "steps_per_sec", "samples_per_sec", "eta_min", "grad_norm")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers,
    where a CPU torch step with a thread per core slows several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("split"))
    write_dvps_split(root, "train", num_seqs=2, frames_per_seq=3, h=H, w=W)
    one = str(tmp_path_factory.mktemp("one"))
    write_dvps_split(one, "train", num_seqs=1, frames_per_seq=1, h=H, w=W)
    write_dvps_split(one, "val", num_seqs=1, frames_per_seq=2, h=H, w=W, seed=1)
    cfg = model_preset("debug_tiny")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "vars.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump(to_jax_variables(to_numpy_state_dict(model), cfg), f)
    return dict(root=root, one=one, ckpt=ckpt, runs=tmp_path_factory.mktemp("runs"))


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close(got, want, rtol):
    return abs(got - want) <= rtol * abs(want) + 1e-6


def test_cli_matches_jax(setup):
    common = ["--preset", "debug_tiny", "--data-root", setup["root"], "--load-from",
              setup["ckpt"], "--max-steps", "2", "--loader", "thread",
              "--eval-every-epochs", "0"]
    jax_dir = str(setup["runs"] / "jax")
    # one device of the tests' 8-device CPU mesh: the port trains on one card
    jax_argv = common + ["--work-dir", jax_dir, "--set", "parallel.num_data=1"]
    with mock.patch.object(sys, "argv", ["train"] + jax_argv):
        jax_train.main()
    want = _lines(glob.glob(os.path.join(jax_dir, "*.metrics.jsonl"))[0])
    out = train.main(common + ["--work-dir", str(setup["runs"] / "port"), "--device", "cpu"])
    got = _lines(out["metrics_path"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    keys = [k for k in want[0] if k not in NOT_LOSSES]
    assert len(keys) > 20 and set(keys) <= set(got[0])
    bad = {k: (got[0][k], want[0][k]) for k in keys if not _close(got[0][k], want[0][k], 1e-4)}
    assert not bad, bad
    assert _close(got[1]["total_loss"], want[1]["total_loss"], 1e-3)
    assert all(math.isfinite(v) for r in got for v in r.values())
    assert out["start_step"] == 0 and out["end_step"] == 2 and len(out["step_wall_s"]) == 2
    # its last checkpoint restores
    assert [s["step"] for s in out["saves"]] == [2]
    cfg = preset("debug_tiny")
    with torch.device("meta"):
        fresh = PolyphonicFormer(cfg.model)
    state, opt = create_train_state(fresh, cfg, torch.Generator().manual_seed(3), device="cpu")
    state = restore_state(make_manager(str(setup["runs"] / "port")), state, opt)
    assert int(state.step) == 2 and opt.scheduler.last_epoch == 2


def _one_frame_run(setup, work, steps, *extra):
    return train.main(["--preset", "debug_tiny", "--data-root", setup["one"], "--load-from",
                       setup["ckpt"], "--work-dir", str(setup["runs"] / work), "--max-steps",
                       str(steps), "--loader", "thread", "--device", "cpu", "--set",
                       "data.flip_ratio=0", "data.ratio_range=1.0,1.0",
                       "schedule.checkpoint_interval=100", *extra])


def test_resume_continues_exactly(setup):
    whole = _one_frame_run(setup, "whole", 3, "--eval-every-epochs", "3")
    first = _one_frame_run(setup, "resumed", 2, "--eval-every-epochs", "0")
    again = _one_frame_run(setup, "resumed", 3, "--eval-every-epochs", "0", "--resume")
    assert (first["start_step"], first["end_step"]) == (0, 2)
    assert (again["start_step"], again["end_step"]) == (2, 3)
    assert again["restore_s"] is not None
    a = torch.load(whole["saves"][-1]["path"], weights_only=True)
    b = torch.load(again["saves"][-1]["path"], weights_only=True)
    assert a["step"] == b["step"] == 3
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["scheduler"] == ob["scheduler"]
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]
    for i, st in oa["adamw"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, ob["adamw"]["state"][i][key]), (i, key)

    # one epoch is 1 step here: --eval-every-epochs 3 fires once, at step 3
    (ev,) = whole["evals"]
    assert ev["step"] == 3
    cfg = preset("debug_tiny")
    model = build_model(cfg.model, "cpu", state_dict=a["model"])
    ds = CityscapesDVPSDataset(setup["one"], split="val", ref_sample_mode="img")
    want = evaluate_frames(cfg.model, cfg.data, model, ds, ds.images)
    assert set(ev["metrics"]) == {k for k, v in want.items() if isinstance(v, float)}
    for k, v in ev["metrics"].items():
        assert v == want[k] or (math.isnan(v) and math.isnan(want[k])), k


def test_eval_hook_disabled_and_sharded(setup, capsys):
    cfg = dataclasses.replace(preset("debug_tiny"), data=dataclasses.replace(
        preset("debug_tiny").data, data_root=setup["root"]))
    assert make_eval_hook(cfg, lambda: None) is None  # no val split on disk
    assert "eval hook disabled" in capsys.readouterr().out
    # one process: the sharded hook is the unsharded one (several ranks:
    # tests/test_torch_dist_eval.py)
    assert make_eval_hook(cfg, lambda: None, sharded=True) is None
    assert "eval hook disabled" in capsys.readouterr().out


def test_cli_needs_a_card_unless_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.main(["--preset", "debug_tiny", "--data-root", setup["root"],
                    "--work-dir", str(setup["runs"] / "nocard"), "--max-steps", "1"])


def test_experiment_fields_match_jax():
    """The run-level fields the CLI reads, per preset (the model, data and
    schedule parts are pinned by ``tests/test_torch_configs.py``)."""
    for name in ("image_r50_2x", "video_r50_1x", "video_swinl", "debug_tiny",
                 "debug_tiny_video"):
        port, ref = preset(name), jax_preset(name)
        for field in ("work_dir", "seed", "load_from", "resume"):
            assert getattr(port, field) == getattr(ref, field), (name, field)
