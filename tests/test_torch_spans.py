"""The port's profiler spans (``utils/profiling.py::span``) on the CPU.

Off, ``span`` is one shared null context and makes no ``record_function``.
Under ``torch.profiler`` (CPU activity), ``batched_video_step`` over 2 clips
of ``debug_tiny_video`` at 64x128 (as ``tests/test_torch_batched.py`` builds
it) and the 2-frame train step of ``tests/test_torch_video_train.py`` record
their ``serve/``, ``model/`` and ``train/`` spans, each nested under its
step's root span, in the order the step runs them.  The served outputs and
the train metrics and weights are bit-equal with and without a profiler.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from polyphonicformer_torch.configs import model_preset, preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.train.step import create_train_state, make_train_step
from polyphonicformer_torch.utils import profiling

H, W, B = 64, 128, 2
PREFIXES = ("serve/", "model/", "train/")


def _spans(prof):
    """(name, start_ns, end_ns) of the program's spans, by start."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(PREFIXES)]
    return sorted(evs, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner is not outer


def _count(spans, name) -> int:
    return sum(s[0] == name for s in spans)


def test_span_off_is_the_shared_null_context(monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    first, second = profiling.span("serve/step"), profiling.span("train/step")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first:
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("serve/step"):
            pass
    assert made == ["serve/step"]


@pytest.fixture(scope="module")
def served():
    cfg = model_preset("debug_tiny_video", max_per_img=100)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.roi_head.mask_head[-1].fc_cls.bias.zero_()
    step = pipeline.make_batched_video_step(model, cfg, (H, W))
    rng = np.random.RandomState(0)
    base = np.repeat(np.repeat(rng.randn(B, H // 16, W // 16, 3) * 2, 16, 1), 16, 2)
    images = torch.from_numpy((base + 0.1 * rng.randn(B, H, W, 3)).astype(np.float32))
    states = pipeline.init_batched_tracker_states(cfg, B, "cpu")
    fids = torch.tensor([1, 10], dtype=torch.int32)
    plain = step(images, states, fids)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = step(images, states, fids)
    return cfg, plain, traced, _spans(prof)


def test_serving_spans_nest_under_the_step(served):
    cfg, _, _, spans = served
    want = {"serve/step": 1, "serve/network": 1, "model/backbone": 1, "model/neck": 1,
            "model/kernel_head": 1, "model/stage": cfg.num_stages, "serve/fuse": B,
            "serve/detections": B, "serve/track_embeds": 1, "model/track_head": 1,
            "serve/track": 1, "serve/render": B, "serve/stack": 1}
    assert {name: _count(spans, name) for name in want} == want
    assert {s[0] for s in spans} == set(want)
    (root,) = [s for s in spans if s[0] == "serve/step"]
    (network,) = [s for s in spans if s[0] == "serve/network"]
    (embeds,) = [s for s in spans if s[0] == "serve/track_embeds"]
    for s in spans:
        if s is not root:
            assert _inside(s, root), s
        if s[0] in ("model/backbone", "model/neck", "model/kernel_head", "model/stage"):
            assert _inside(s, network), s
    assert all(_inside(s, embeds) for s in spans if s[0] == "model/track_head")
    # the per-clip path runs after the network, the stack last
    after = [s[0] for s in spans if s[1] >= network[2]]
    assert after[:2 * B] == ["serve/fuse"] * B + ["serve/detections"] * B
    assert after[-1] == "serve/stack"


def _equal(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


def test_serving_outputs_bit_equal_with_the_profiler(served):
    _, plain, traced, _ = served
    _equal(plain, traced)


def _train_run(compute_dtype: str, profiled: bool):
    exp = preset("debug_tiny_video")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                             compute_dtype=compute_dtype))
    model = build_model(exp.model, "cpu", generator=torch.Generator().manual_seed(0))
    state, opt = create_train_state(model, exp, None, steps_per_epoch=1000, device="cpu")
    step = make_train_step(state.model, exp, opt, video=True)
    batch = synthetic_batch(exp.model, B, (H, W), two_frame=True, seed=0, device="cpu")
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext()
    with prof:
        state, metrics = step(state, batch)
    spans = _spans(prof) if profiled else None
    return {k: v.clone() for k, v in state.model.state_dict().items()}, metrics, spans


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request):
    return (request.param, _train_run(request.param, False),
            _train_run(request.param, True))


def test_train_spans_in_order_under_the_step(trained):
    dtype, _, (_, _, spans) = trained
    order = [s[0] for s in spans if s[0].startswith("train/")]
    cast = ["train/cast"] if dtype == "bfloat16" else []
    grad_cast = ["train/grad_cast"] if dtype == "bfloat16" else []
    # the guard clones the state before the optimizer and selects after it
    assert order == (["train/step", "train/prep"] + cast + [
        "train/forward_losses", "train/assign", "train/losses", "train/track_losses",
        "train/backward"] + grad_cast + [
        "train/clip", "train/guard", "train/optimizer", "train/guard"])
    (root,) = [s for s in spans if s[0] == "train/step"]
    assert all(_inside(s, root) for s in spans if s is not root)
    (fwd,) = [s for s in spans if s[0] == "train/forward_losses"]
    (bwd,) = [s for s in spans if s[0] == "train/backward"]
    for name in ("train/assign", "train/losses", "train/track_losses"):
        assert all(_inside(s, fwd) for s in spans if s[0] == name), name
    # key and ref frames in the forward; the remat's recompute in the backward
    backbones = [s for s in spans if s[0] == "model/backbone"]
    assert sum(_inside(s, fwd) for s in backbones) == 2
    assert sum(_inside(s, bwd) for s in backbones) == 1


def test_train_step_bit_equal_with_the_profiler(trained):
    _, (w0, m0, _), (w1, m1, _) = trained
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
