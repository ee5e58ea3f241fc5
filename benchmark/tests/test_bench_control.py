"""The control on the card: the reference put in the program's place and
computed in the precision below the configuration's (TF32 for the f32 R50
training, float8 for the bf16 Swin-L cells) comes out not correct against
each cell's limits, and the program comes out correct, at the cells' widths
on 256x512 images (``python -m benchmark.control`` reads the same at the
cells' own sizes).  Marked ``cuda``: skips without a card."""
import dataclasses
import json
import time

import pytest
import torch

from benchmark import cells
from benchmark.control import control_serve, control_train
from benchmark.run import Context, run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _small(workload: str, tmp_path) -> cells.Cell:
    cell = cells.load(workload)
    cfg = dict(cell.config, image_hw=[256, 512])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return dataclasses.replace(cell, config=cfg, config_path=path)


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v["limit"] for k, v in limits.items() if k in readings)


@pytest.mark.parametrize("workload", ["r50_train_video_b2", "swinl_train_video_b2"])
def test_training_control_is_not_correct(card, tmp_path, workload):
    cell = _small(workload, tmp_path)
    assert _fails(control_train(cell, 2 ** 33 + 1, card), cell.limits)
    res = run_cell(Context(cell=cell, seed=2 ** 33 + 1, seconds=2.0, trace=False,
                           device=card, started=time.time()))
    assert all(v <= lim for _, v, lim in res.checks), res.checks


def test_serving_control_is_not_correct(card, tmp_path):
    cell = _small("swinl_serve_4streams", tmp_path)
    assert _fails(control_serve(cell, 2 ** 33 + 2, card), cell.limits)
