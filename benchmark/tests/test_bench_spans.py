"""The span reader (``benchmark/spans.py``) on synthetic traces and on a CPU
profile: launches and device ms by span, each idle gap put down to the
span whose launch ended it, a launch of the backward's thread put down to
``train/backward``, and the groups' idle summing to the window's; the span
metrics (``benchmark/metrics/*_ms.*.py``) read from such a reading."""
import random

import pytest
import torch

from benchmark import cells, spans as S, trace as T
from polyphonicformer_torch.utils.profiling import span

MAIN, AUTOGRAD = 1, 2
SPAN_METRICS = ("clip_path_host_ms.serve", "clip_path_idle_ms.serve", "network_idle_ms.serve",
                "forward_idle_ms.train", "backward_idle_ms.train", "update_idle_ms.train")


def _read(reading, kind, units) -> dict:
    """The span metrics that a traced run of ``kind`` over ``units`` frames
    or samples gives from ``reading``, in us."""
    trace = T.Trace(kind=kind, steps=1, frames=units if kind == "serve" else 0,
                    samples=units if kind == "train" else 0, span_s=1.0, busy_s=0.0,
                    device=[], ops=[], port_s=0.0, step_flops=0.0, compute_dtype="float32",
                    spans=reading)
    out = {n: cells.metric_reader(n)(trace) for n in SPAN_METRICS}
    return {n: v * 1e3 for n, v in out.items() if v is not None}


def _train_trace():
    """A train step [0, 100) us on the main thread; the remat's backbone on
    the autograd thread at [50, 60); six launches, one a kernel."""
    spans = [S.Span("train/step", MAIN, 0, 100), S.Span("train/forward_losses", MAIN, 10, 40),
             S.Span("model/backbone", MAIN, 12, 30), S.Span("train/backward", MAIN, 40, 80),
             S.Span("train/optimizer", MAIN, 85, 95),
             S.Span("model/backbone", AUTOGRAD, 50, 60)]
    launches = [S.Launch(1, MAIN, 5), S.Launch(2, MAIN, 15), S.Launch(3, AUTOGRAD, 45),
                S.Launch(4, AUTOGRAD, 55), S.Launch(5, MAIN, 90), S.Launch(6, MAIN, 105)]
    kernels = [S.Kernel(1, 6, 10), S.Kernel(2, 20, 30), S.Kernel(3, 46, 50),
               S.Kernel(4, 56, 70), S.Kernel(5, 92, 96), S.Kernel(6, 106, 108)]
    return spans, launches, kernels, (0, 110)


def test_launches_and_device_ms_by_span():
    r = S.attribute(*_train_trace())
    got = {n: (row["launches"], row["device_ms"] * 1e3) for n, row in r.rows.items()
           if row["launches"]}
    assert got == {S.STEP: (1, 4), "model/backbone": (2, 24), "train/backward": (1, 4),
                   "train/optimizer": (1, 4), S.OUTSIDE: (1, 2)}
    assert r.rows["model/backbone"]["calls"] == 2
    assert r.rows["train/step"]["host_ms"] * 1e3 == pytest.approx(100)
    # the step's self time: less its three children on the main thread
    assert r.rows["train/step"]["self_ms"] * 1e3 == pytest.approx(100 - 30 - 40 - 10)
    assert r.rows["train/forward_losses"]["self_ms"] * 1e3 == pytest.approx(30 - 18)


def test_gap_goes_to_the_launching_span():
    r = S.attribute(*_train_trace())
    idle = {n: row["idle_ms"] * 1e3 for n, row in r.rows.items() if row["idle_ms"]}
    # [0, 6) step; [10, 20) and [50, 56) backbone (forward, then its recompute);
    # [30, 46) the autograd thread's launch outside any of its spans;
    # [70, 92) optimizer; [96, 106) and the tail [108, 110) outside
    assert idle == pytest.approx({S.STEP: 6, "model/backbone": 16, "train/backward": 16,
                                  "train/optimizer": 22, S.OUTSIDE: 12})


def test_backward_thread_launches_group_under_backward():
    r = S.attribute(*_train_trace())
    groups = {n: v * 1e3 for n, v in r.groups.items()}
    assert groups == pytest.approx({S.STEP: 6, "train/forward_losses": 10,
                                    "train/backward": 22, "train/optimizer": 22,
                                    S.OUTSIDE: 12})
    got = _read(r, "train", 2)
    assert set(got) == {"forward_idle_ms.train", "backward_idle_ms.train",
                        "update_idle_ms.train"}
    assert got["forward_idle_ms.train"] == pytest.approx(5)
    assert got["backward_idle_ms.train"] == pytest.approx(11)
    assert got["update_idle_ms.train"] == pytest.approx(11)
    assert _read(r, "serve", 2) == {}


def _serve_reading():
    spans = [S.Span("serve/step", MAIN, 0, 50), S.Span("serve/network", MAIN, 0, 20),
             S.Span("model/backbone", MAIN, 1, 10), S.Span("serve/fuse", MAIN, 20, 30),
             S.Span("serve/fuse", MAIN, 30, 36), S.Span("serve/stack", MAIN, 40, 45)]
    launches = [S.Launch(1, MAIN, 2), S.Launch(2, MAIN, 22), S.Launch(3, MAIN, 31),
                S.Launch(4, MAIN, 41)]
    kernels = [S.Kernel(1, 4, 20), S.Kernel(2, 24, 28), S.Kernel(3, 32, 33),
               S.Kernel(4, 42, 44)]
    return S.attribute(spans, launches, kernels, (0, 50))


def test_serving_metrics():
    r = _serve_reading()
    got = _read(r, "serve", 2)
    assert got == pytest.approx({"clip_path_host_ms.serve": (10 + 6 + 5) / 2,
                                 "clip_path_idle_ms.serve": (4 + 4 + 9) / 2,
                                 "network_idle_ms.serve": 4 / 2})
    assert r.rows["model/backbone"]["idle_ms"] * 1e3 == pytest.approx(4)


# what spans.metrics (a dict of the six, removed for these files) gave on the
# readings above, in us
DICT_GAVE = {("serve", "clip_path_host_ms.serve"): 10.5, ("serve", "clip_path_idle_ms.serve"): 8.5,
             ("serve", "network_idle_ms.serve"): 2.0, ("train", "forward_idle_ms.train"): 5.0,
             ("train", "backward_idle_ms.train"): 11.0, ("train", "update_idle_ms.train"): 11.0}


@pytest.mark.parametrize("kind, name", sorted(DICT_GAVE))
def test_metric_file_gives_what_the_dict_gave(kind, name):
    r = _serve_reading() if kind == "serve" else S.attribute(*_train_trace())
    trace = T.Trace(kind=kind, steps=1, frames=2 if kind == "serve" else 0,
                    samples=2 if kind == "train" else 0, span_s=1.0, busy_s=0.0, device=[],
                    ops=[], port_s=0.0, step_flops=0.0, compute_dtype="float32", spans=r)
    read = cells.metric_reader(name)
    assert read(trace) * 1e3 == pytest.approx(DICT_GAVE[kind, name])
    # nothing to read: another kind of run, no span pass, or no spans recorded
    other = "train" if kind == "serve" else "serve"
    assert read(T.Trace(**{**trace.__dict__, "kind": other})) is None
    assert read(T.Trace(**{**trace.__dict__, "spans": None})) is None
    bare = S.attribute([], [], [S.Kernel(1, 0, 1)], (0, 2))
    assert read(T.Trace(**{**trace.__dict__, "spans": bare})) is None


def test_unmatched_kernel_counts_outside():
    r = S.attribute([], [], [S.Kernel(9, 5, 7)], (0, 10))
    assert r.rows[S.OUTSIDE]["launches"] == 1
    assert r.groups[S.OUTSIDE] * 1e3 == pytest.approx(8)


@pytest.mark.parametrize("seed", range(5))
def test_groups_partition_the_window_idle(seed):
    rng = random.Random(seed)
    spans, launches, kernels = [], [], []
    t = 0.0
    for step in range(3):
        s0 = t
        for child in ("train/prep", "train/forward_losses", "train/backward", "train/clip",
                      "train/optimizer"):
            c0 = t
            for _ in range(rng.randint(0, 5)):
                t += rng.uniform(0.5, 3)
                corr = len(launches) + 1
                thread = AUTOGRAD if child == "train/backward" and rng.random() < 0.5 else MAIN
                launches.append(S.Launch(corr, thread, t))
                k0 = t + rng.uniform(0, 20)
                kernels.append(S.Kernel(corr, k0, k0 + rng.uniform(0.1, 15)))
            t += rng.uniform(0.1, 2)
            spans.append(S.Span(child, MAIN, c0, t))
        t += 1
        spans.append(S.Span("train/step", MAIN, s0, t))
    window = (-1.0, max([t] + [k.end for k in kernels]) + 1)
    r = S.attribute(spans, launches, kernels, window)
    busy = S.attribute([], [], kernels, window).busy_ms
    assert r.busy_ms == pytest.approx(busy)
    assert sum(r.groups.values()) == pytest.approx(r.idle_ms)
    assert sum(row["idle_ms"] for row in r.rows.values()) == pytest.approx(r.idle_ms)
    assert r.idle_ms == pytest.approx(r.window_ms - busy)
    assert sum(row["launches"] for row in r.rows.values()) == len(kernels)


def test_reads_a_cpu_profile():
    def step():
        with span("train/step"):
            with span("train/prep"):
                torch.ones(4) + 1
            with span("train/backward"):
                torch.ones(4) * 2

    spans, launches, kernels, window = S.from_profile(S.span_pass(step, 2, lambda: None))
    assert window[0] <= min(s.start for s in spans)
    assert [s.name for s in sorted(spans, key=lambda s: s.start)] == \
        ["train/step", "train/prep", "train/backward"] * 2
    assert not kernels and len({s.thread for s in spans}) == 1
    r = S.attribute(spans, launches, kernels, window)
    assert r.rows["train/step"]["calls"] == 2 and r.busy_ms == 0
    assert r.groups == {S.OUTSIDE: pytest.approx(r.window_ms)}
    lines = S.table_lines(r, 2)
    assert any(line.startswith("span train/prep: 1,") for line in lines)
    assert lines[-1] == f"span groups, idle ms: {S.OUTSIDE} {r.window_ms / 2:.3f}"
