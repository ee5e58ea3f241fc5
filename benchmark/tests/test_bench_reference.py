"""The benchmark's plain reference against the port's CPU path, at the
``debug_tiny_video`` widths (128x256), and the benchmark's imports.

Serving: 2 streams x 3 frames through the port's ``batched_video_step`` and
the reference's, from one state dict (``benchmark/weights.py``, the last
stage's class bias 0): the maps and every tracker state field equal.  On the
CPU the port takes its kernels' plain versions, which the reference
restates, so they agree exactly.  Training: one 2-frame step at batch 2:
losses and the gradient norm within 1e-4 (the reference takes the rank
loss's logsumexp in one call, the port query by query, and its gradients by
autograd, not the port's custom backward), every leaf's change within 1e-2
of the largest of its own and the median leaf's (Adam's first step
divides each element by its own magnitude).

Imports: every module of ``benchmark`` loads without ``jax``, ``jaxlib``,
``flax``, ``optax`` or ``polyphonicformer_tpu`` (top-level names compared
whole), and no module of ``benchmark/reference`` loads
``polyphonicformer_torch``.
"""
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from benchmark import program, weights
from benchmark.check.train import gaps
from benchmark.entries.train_video import readings
from benchmark.reference import config as ref_config
from benchmark.reference.infer import pipeline as rpipe
from benchmark.reference.models.polyphonic import build_model as ref_build
from benchmark.traffic import moving_blocks, synthetic_batch

from .tiny import serve_cell, train_cell

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "polyphonicformer_tpu")


def _modules(sub: str = ""):
    base = ROOT / "benchmark" / sub
    out = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "." in p.stem:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def _loaded_after_import(modules, extra: str = "") -> set:
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_benchmark_imports_no_jax():
    metrics = sorted(p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.*.py"))
    extra = ("from benchmark import cells\n"
             f"for n in {metrics!r}: cells.metric_reader(n)\n"
             "import benchmark.entries.serve_batched, benchmark.entries.train_video\n"
             "import polyphonicformer_torch.infer.pipeline, polyphonicformer_torch.train.step")
    loaded = _loaded_after_import(_modules(), extra)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    mods = _modules("reference")
    assert len(mods) > 20
    loaded = _loaded_after_import(mods)
    assert "polyphonicformer_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
    for p in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "polyphonicformer_torch" not in p.read_text().replace(
            "polyphonicformer_torch`", ""), p


def _serve_both(tmp_path, frames_n=3):
    from polyphonicformer_torch.infer import pipeline as ppipe
    from polyphonicformer_torch.models import build_model

    cell = serve_cell(tmp_path)
    cfg, exp = program.experiment(cell.config), ref_config.experiment(cell.config)
    hw = tuple(cell.config["image_hw"])
    sd = weights.state_dict(exp, 11, "cpu", zero_class_bias=True)
    frames = moving_blocks.pool(cell.mix, hw, 11, torch.device("cpu"))
    port = ppipe.make_batched_video_step(build_model(cfg.model, "cpu", state_dict=sd),
                                         cfg.model, hw)
    ref = rpipe.make_batched_video_step(ref_build(exp.model, sd, "cpu"), exp.model, hw)
    sp = ppipe.init_batched_tracker_states(cfg.model, 2, "cpu")
    sr = rpipe.init_batched_tracker_states(exp.model, 2, "cpu")
    outs = []
    for t in range(frames_n):
        op, sp = port(frames[t], sp, [t, t])
        orf, sr = ref(frames[t], sr, [t, t])
        outs.append((op, sp, orf, sr))
    return outs


def test_serving_maps_and_tracker_match_the_port(tmp_path):
    outs = _serve_both(tmp_path)
    tracked = 0
    for op, sp, orf, sr in outs:
        for k in ("semantic", "panoptic", "track_map", "depth"):
            assert torch.equal(getattr(op, k), getattr(orf, k)), k
        for f in dataclasses.fields(sp):
            assert torch.equal(getattr(sp, f.name), getattr(sr, f.name)), f.name
        tracked += int((op.track_map > 0).sum())
    assert tracked > 0  # the tracker had something to do


def test_train_step_matches_the_port(tmp_path):
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    from benchmark.check.train import reference_readings

    cell = train_cell(tmp_path)
    cfg, exp = program.experiment(cell.config), ref_config.experiment(cell.config)
    hw = tuple(cell.config["image_hw"])
    sd = weights.state_dict(exp, 5, "cpu")
    parts = synthetic_batch.pool(dict(cell.mix, pool=1), exp.model, 2, hw, 5, "cpu")
    state, opt = create_train_state(build_model(cfg.model, "cpu", state_dict=sd), cfg, None,
                                    1000, device="cpu")
    step = make_train_step(state.model, cfg, opt, video=True)
    _, got = readings(step, state, opt, [program.train_batch(p) for p in parts], 1)
    ref = reference_readings(exp, sd, parts, 1, "cpu", 1000)
    found = gaps(got, ref)
    assert found["loss_gap"][0] < 1e-4, found["loss_gap"]
    assert found["grad_norm_gap"][0] < 1e-4
    assert found["first_grad_gap"][0] < 1e-3, found["first_grad_gap"]
    assert found["change_gap"][0] < 1e-2, found["change_gap"]
    assert statistics.median(ref["change"].values()) > 0
