"""The harness (``benchmark/run.py``, ``benchmark/cells.py``) on the CPU.

* every workload of ``BENCHMARK.json`` resolves to its configuration,
  traffic and limits files, and every per-layer metric to its reader;
* a configuration, a traffic mix and a per-layer metric added as new files
  in a copy of the folder are found with no edit to an existing file; so are
  a new backbone with its own neck and init stds (the reference builds,
  draws, runs and counts it), a kernel's roofline file with its device
  names, and a metric over the span pass;
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

from benchmark import cells, run, spans as S, trace as T
from benchmark.reference.models import polyphonic

from .tiny import _config, correct, run_on_cpu, serve_cell, train_cell

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


# a backbone of two strided convolutions with its own neck: ViTDet's simple
# feature pyramid in small (a deconvolution up to stride 4, a max-pool to 32)
TINY_PLAIN = '''"""Two strided convolutions (stride 8) and a simple pyramid."""
import torch
from torch import nn
from torch.nn import functional as F

INIT_STD = {"pos_embed": 0.02}


class Backbone(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.patch = nn.Conv2d(3, dim, 4, 4)
        self.down = nn.Conv2d(dim, dim, 3, 2, padding=1)
        self.pos_embed = nn.Parameter(torch.zeros(1, dim, 16, 16))

    def forward(self, x):
        y = F.gelu(self.patch(x))
        y = y + F.interpolate(self.pos_embed, size=y.shape[-2:], mode="bilinear")
        return F.gelu(self.down(y))


class Neck(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.up = nn.ConvTranspose2d(dim, out, 2, 2)
        self.same = nn.Conv2d(dim, out, 1)
        self.down = nn.Conv2d(dim, out, 3, 2, padding=1)

    def forward(self, x):
        p4 = self.down(x)
        return self.up(x), self.same(x), p4, F.max_pool2d(p4, 2)


def build(cfg):
    return Backbone(32), Neck(32, cfg.fpn_out_channels)
'''
TINY_OP = '''"""A kernel of the new backbone."""
DEVICE_NAMES = ("tiny_plain_kernel",)


def cost(shapes, dtypes, scalars):
    return 4.0, 0.0, "float32"
'''
TINY_METRIC = '''"""Idle ms a frame put down to the network, by a new file."""
from benchmark.metrics._common import span_ms


def read(trace):
    return span_ms(trace, "serve", ("serve/network",), "idle")
'''


BACKBONE_CHECK = '''import json, sys
import torch
import benchmark
from benchmark import weights
from benchmark.reference import config as ref_config
from benchmark.reference.models import polyphonic
from benchmark.roofline import model_flops

exp = ref_config.load(sys.argv[1])
assert exp.model.backbone == "tiny_plain"
sd = weights.state_dict(exp, 3, "cpu")
model = polyphonic.build_model(exp.model, sd, "cpu")
with torch.no_grad():
    feats = model.extract_feat(torch.randn(1, 128, 256, 3))
    out = model.forward_heads(feats)
print(json.dumps({
    "package": benchmark.__path__[0],
    "pos_embed_std": float(sd["backbone.pos_embed"].std()),
    "patch_std": float(sd["backbone.patch.weight"].std()),
    "neck_bias_max": float(sd["neck.down.bias"].abs().max()),
    "feats": [list(f.shape) for f in feats],
    "masks_hw": list(out.stages[-1].mask_preds.shape[-2:]),
    "serve_flops": model_flops.serve_flops(exp, 1, (128, 256))}))
'''


def test_new_files_are_found_without_edits(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "reference" / "backbones" / "tiny_plain.py").write_text(TINY_PLAIN)
    (root / "roofline" / "tiny_op.py").write_text(TINY_OP)
    (root / "metrics" / "tiny_idle_ms.serve.py").write_text(TINY_METRIC)
    tiny_cfg = _config("video_r50_1x", "tiny_plain", root / "configs" / "video_tiny_plain.json")
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

    # the backbone: built, drawn at its declared std, run and counted by the
    # copy's own package, imported from the copy
    out = subprocess.run([sys.executable, "-c", BACKBONE_CHECK, str(tiny_cfg)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert Path(got["package"]).parent == tmp_path
    assert got["pos_embed_std"] == pytest.approx(0.02, rel=0.05)
    assert got["patch_std"] == pytest.approx(48 ** -0.5, rel=0.1)
    assert got["neck_bias_max"] == 0.0
    assert got["feats"] == [[1, 64, 128 // s, 256 // s] for s in (4, 8, 16, 32)]
    assert got["masks_hw"] == [16, 32]
    # the two strided convolutions alone: 2 (32 x 64 x 32 x 48 + 16 x 32 x 32 x 288)
    assert got["serve_flops"] > 2 * (32 * 64 * 32 * 48 + 16 * 32 * 32 * 288)
    with pytest.raises(ValueError, match="no_such_net.py"):
        polyphonic.backbone_file("no_such_net", root / "reference" / "backbones")

    # its kernel: the program's own by its roofline file
    classes = T.kernel_classes(root / "roofline")
    assert T.kernel_class("void tiny_plain_kernel<64>(float*)", classes) == "port"
    assert T.kernel_class("void tiny_plain_kernel<64>(float*)") == "other"

    # a metric over the span pass
    reading = S.attribute([S.Span("serve/step", 1, 0, 50), S.Span("serve/network", 1, 0, 20)],
                          [S.Launch(1, 1, 2)], [S.Kernel(1, 6, 20)], (0, 50))
    trace = T.Trace(kind="serve", steps=1, frames=2, samples=0, span_s=1.0, busy_s=0.0,
                    device=[], ops=[], port_s=0.0, step_flops=0.0, compute_dtype="float32",
                    spans=reading)
    assert cells.metric_reader("tiny_idle_ms.serve", root)(trace) == pytest.approx(6e-3 / 2)

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
