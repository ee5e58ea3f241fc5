"""The harness (``benchmark/run.py``, ``benchmark/cells.py``) on the CPU.

* every workload of ``BENCHMARK.json`` resolves to its configuration,
  traffic and limits files, and every per-layer metric to its reader;
* a configuration, a traffic mix and a per-layer metric added as new files
  in a copy of the folder are found with no edit to an existing file;
* a run without a card exits non-zero and prints no result;
* the result line has the contract's keys, ``checks`` last;
* a run whose timed path is broken underneath (the step returns its state
  unchanged; half of the batch left out; an answer altered where it is
  produced, in the maps or in an update stage's pooling) comes out not
  correct, while the sound run is correct.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, run

from .tiny import correct, run_on_cpu, serve_cell, train_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workloads_resolve(workload):
    cell = cells.load(workload)
    assert cell.config_path.is_file() and cell.mix["entry"]
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    assert cells.entry(cell.mix).run
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_new_files_are_found_without_edits(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "video_r50_1x.json").read_text())
    (root / "configs" / "video_r50_new.json").write_text(json.dumps(dict(cfg, name="new")))
    mix = json.loads((root / "traffic" / "train_video_b2.json").read_text())
    (root / "traffic" / "train_video_b4.json").write_text(json.dumps(dict(mix, pool=8)))
    (root / "limits" / "new_cell.json").write_text(
        (root / "limits" / "r50_train_video_b2.json").read_text())
    (root / "metrics" / "steps.train.py").write_text(
        "def read(trace):\n    return float(trace.steps)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new_cell", "config": "video_r50_new",
                               "traffic": "train_video_b4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "train entry",
                               "moves": "train_samples_per_s", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("new_cell", tmp_path / "BENCHMARK.json", root)
    assert cell.config["name"] == "new" and cell.mix["pool"] == 8
    assert "steps.train" in {m["name"] for m in cell.per_layer}
    reader = cells.metric_reader("steps.train", root)
    assert reader(type("T", (), {"steps": 3})()) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_result_line_keys():
    cell = cells.load(BENCH["workloads"][0]["name"])
    res = run.Result(setup_s=1.0, attempted=4, failed=0,
                     end_to_end={m["name"]: 1.0 for m in cell.end_to_end},
                     memory_peak_bytes=1, checks=[("a", 0.0, 1.0)])
    line = run.result_line(cell, res, False, {"platform": "gpu", "kind": "x", "count": 1,
                                             "memory_peak_bytes": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    res.checks = [("a", 2.0, 1.0)]
    assert run.result_line(cell, res, False, {})["correct"] is False
    res.checks = [("a", None, 1.0)]
    assert run.result_line(cell, res, False, {})["correct"] is False


# --- faults planted in the program, on the CPU at the tiny size ---

def _serve_fault(monkeypatch, fault):
    from polyphonicformer_torch.infer import pipeline

    if fault == "state_unchanged":
        real = pipeline._track_and_render
        monkeypatch.setattr(pipeline, "_track_and_render",
                            lambda cfg, pano, det, emb, state, fid:
                            (real(cfg, pano, det, emb, state, fid)[0], state))
    elif fault == "half_batch":
        real = pipeline._heads
        half = lambda images: torch.cat([images[:images.shape[0] // 2]] * 2)  # noqa: E731
        monkeypatch.setattr(pipeline, "_heads",
                            lambda model, images, dt: real(model, half(images), dt))
    elif fault == "answer_altered":
        real = pipeline.render_maps

        def altered(*args):
            semantic, panoptic, depth, track = real(*args)
            semantic = semantic.clone()
            semantic[0, 0] += 1
            return semantic, panoptic, depth, track

        monkeypatch.setattr(pipeline, "render_maps", altered)
    elif fault == "pool_altered":  # each update stage's queries pool their neighbour's mask
        from polyphonicformer_torch.models import kernel_update_head

        real = kernel_update_head.masked_pool
        monkeypatch.setattr(kernel_update_head, "masked_pool",
                            lambda *args: real(*args).roll(1, dims=1))


def _train_fault(monkeypatch, fault):
    from polyphonicformer_torch.data.structures import GTSample
    from polyphonicformer_torch.train import optim, step

    if fault == "state_unchanged":
        monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    elif fault == "half_batch":
        real = step.video_forward_losses

        def half(model, cfg, batch):
            cut = lambda g: GTSample(*(x[:1] for x in g))  # noqa: E731
            return real(model, cfg, batch._replace(image=batch.image[:1], gt=cut(batch.gt),
                                                   ref_image=batch.ref_image[:1],
                                                   ref_gt=cut(batch.ref_gt)))

        monkeypatch.setattr(step, "video_forward_losses", half)
    elif fault == "answer_altered":
        real = step.video_forward_losses

        def altered(model, cfg, batch):
            total, losses = real(model, cfg, batch)
            return total * 1.1, losses

        monkeypatch.setattr(step, "video_forward_losses", altered)


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered",
                                   "pool_altered"])
def test_serving_fault_is_not_correct(tmp_path, monkeypatch, fault):
    _serve_fault(monkeypatch, fault)
    res = run_on_cpu(serve_cell(tmp_path), seconds=3.0)
    assert correct(res) is (fault is None), res.checks


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_training_fault_is_not_correct(tmp_path, monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    res = run_on_cpu(train_cell(tmp_path), seconds=1.0)
    assert correct(res) is (fault is None), res.checks
