"""The port's checkpoint-parity runbook (``tools/parity_check.py``) on the
CPU, over ``data/synthetic_split.py``'s split (1 sequence of 3 frames,
64x128) and mmcv-style ``.pth`` files of seeded ``debug_tiny`` (image) and
``debug_tiny_video`` weights (the last stage's ``fc_cls`` bias 0, as in
``test_torch_slice.py``).

- Its measured dict (``parity.json``) equals what the port's
  ``eval_image`` and ``eval_video`` CLIs give for the same checkpoints,
  converted by the port's converter CLI.
- ``check_gates`` agrees with the JAX package's on the same dicts, the
  printed PASS/FAIL/UNVERIFIED lines included.
- The exit code is 0 with the gates set to the measured values and 1 with
  one of them moved beyond its tolerance.
"""
import json
import os

import pytest
import torch

from polyphonicformer_tpu.tools import parity_check as jax_parity_check
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.data.synthetic_split import write_dvps_split
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.tools import convert_torch_ckpt, eval_image, eval_video, parity_check

torch.set_num_threads(2)
H, W = 64, 128


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    data = str(root / "data")
    write_dvps_split(data, "val", num_seqs=1, frames_per_seq=3, h=H, w=W)
    pths = {}
    for kind, preset in (("image", "debug_tiny"), ("video", "debug_tiny_video")):
        model = build_model(model_preset(preset), "cpu",
                            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.roi_head.mask_head[-1].fc_cls.bias.zero_()
        pths[kind] = str(root / f"{kind}.pth")
        torch.save({"state_dict": model.state_dict(), "meta": {"epoch": 1}}, pths[kind])
    return root, data, pths


def _run(setup, workdir, *extra, video=True):
    root, data, pths = setup
    argv = ["--image-pth", pths["image"], "--data-root", data, "--preset-image", "debug_tiny",
            "--workdir", str(workdir), "--device", "cpu", *extra]
    if video:
        argv += ["--video-pth", pths["video"], "--preset-video", "debug_tiny_video",
                 "--clip-len", "3", "--workers", "1", "--nproc", "2"]
    return parity_check.main(argv)


def test_measured_equals_eval_clis(setup, tmp_path):
    root, data, pths = setup
    assert _run(setup, tmp_path / "parity") == 0  # no --expected: UNVERIFIED
    with open(tmp_path / "parity" / "parity.json") as f:
        measured = json.load(f)

    want = {}
    for kind, preset in (("image", "debug_tiny"), ("video", "debug_tiny_video")):
        pkl = str(tmp_path / f"{kind}.pkl")
        convert_torch_ckpt.main(["--ckpt", pths[kind], "--out", pkl]
                                + (["--video"] if kind == "video" else []))
        if kind == "image":
            metrics = eval_image.main(["--data-root", data, "--checkpoint", pkl, "--preset",
                                       preset, "--device", "cpu"])
            want.update({k: v for k, v in metrics.items() if isinstance(v, float)})
        else:
            out = eval_video.main(["--data-root", data, "--checkpoint", pkl, "--preset", preset,
                                   "--eval-dir", str(tmp_path / "video_eval"), "--clip-len", "3",
                                   "--workers", "1", "--nproc", "2", "--f32-depth",
                                   "--device", "cpu"])
            for cell, vals in out["results"].items():
                for name, v in vals.items():
                    want[f"dvpq_{cell}" if name == "pq" else f"dvpq_{cell}_{name[3:]}"] = v
            want["dvpq_average"] = out["results"]["average"]["pq"]
    assert measured == want
    assert "dvpq_average" in measured and "depth_abs_rel" in measured
    assert os.path.exists(tmp_path / "parity" / "image_vars.pkl")


GATE_CASES = [
    ({"pq@inf": 0.5}, {}),
    ({"pq@inf": 0.5, "depth_abs_rel": 0.08, "dvpq_average": 40.0},
     {"pq@inf": 0.5004, "depth_abs_rel": 0.0815, "dvpq_average": 40.05}),
    ({"pq@inf": 0.5, "depth_abs_rel": 0.08, "dvpq_average": 40.0},
     {"pq@inf": 0.502, "depth_abs_rel": 0.079, "dvpq_average": 39.8}),
    ({"pq@inf": 0.5}, {"pq@inf": 0.5, "dvpq_k1_l0.5": 10.0}),
]


@pytest.mark.parametrize("measured,expected", GATE_CASES)
def test_check_gates_matches_jax(measured, expected, capsys):
    ok = parity_check.check_gates(measured, expected, 0.1, 0.001, 0.002)
    port_out = capsys.readouterr().out
    want = jax_parity_check.check_gates(measured, expected, 0.1, 0.001, 0.002)
    assert ok == want
    assert port_out == capsys.readouterr().out


def test_exit_codes(setup, tmp_path):
    """Image stage alone: gates at the measured values pass; PQ moved by
    twice its tolerance fails."""
    assert _run(setup, tmp_path / "a", video=False) == 0
    with open(tmp_path / "a" / "parity.json") as f:
        measured = json.load(f)
    gates = [f"{k}={measured[k]!r}" for k in ("pq@inf", "depth_abs_rel")]
    assert _run(setup, tmp_path / "b", "--expected", *gates, video=False) == 0
    moved = f"pq@inf={measured['pq@inf'] + 0.002!r}"
    assert _run(setup, tmp_path / "c", "--expected", moved, gates[1], video=False) == 1
