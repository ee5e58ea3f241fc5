"""Cells of the benchmark at CPU-test sizes: the ``debug_tiny_video``
widths at 128x256, with the cell's own traffic mix made smaller in count,
never in kind."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from benchmark import cells, run

HERE = Path(__file__).resolve().parents[1]


def _config(base: str, backbone: str, path: Path) -> Path:
    from polyphonicformer_torch.configs import preset

    cfg = json.loads((HERE / "configs" / f"{base}.json").read_text())
    exp = dataclasses.asdict(preset("debug_tiny_video"))
    exp["model"]["backbone"] = backbone
    dtype = "bfloat16" if backbone.startswith("swin") else "float32"
    exp["model"]["compute_dtype"] = dtype
    cfg.update(preset="debug_tiny_video", image_hw=[128, 256], experiment=exp,
               train={"compute_dtype": dtype, "tf32": False})
    path.write_text(json.dumps(cfg))
    return path


def serve_cell(tmp: Path, backbone: str = "resnet50") -> cells.Cell:
    mix = json.loads((HERE / "traffic" / "serve_4streams.json").read_text())
    mix.update(name="serve_4streams", streams=2, cycle_frames=4, warm_steps=1,
               check_sample_below=4)
    limits = json.loads((HERE / "limits" / "swinl_serve_4streams.json").read_text())
    return cells.Cell(name="tiny_serve", chips=1,
                      config_path=_config("video_swinl", backbone, tmp / "serve.json"),
                      config=json.loads((tmp / "serve.json").read_text()), mix=mix,
                      limits=limits, end_to_end=[], per_layer=[])


def train_cell(tmp: Path, backbone: str = "resnet50") -> cells.Cell:
    mix = json.loads((HERE / "traffic" / "train_video_b2.json").read_text())
    mix.update(name="train_video_b2", max_instances=6)
    name = "swinl_train_video_b2" if backbone.startswith("swin") else "r50_train_video_b2"
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return cells.Cell(name="tiny_train", chips=1,
                      config_path=_config("video_r50_1x", backbone, tmp / "train.json"),
                      config=json.loads((tmp / "train.json").read_text()), mix=mix,
                      limits=limits, end_to_end=[], per_layer=[])


def run_on_cpu(cell: cells.Cell, seconds: float, seed: int = 2 ** 33 + 7) -> run.Result:
    """A run of ``cell`` on the CPU, past the harness's look for a card."""
    ctx = run.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=torch.device("cpu"), started=time.time())
    return run.run_cell(ctx)


def correct(res: run.Result) -> bool:
    return bool(res.checks) and all(v is not None and v <= lim for _, v, lim in res.checks)
