"""The card's idle time put down to the program's spans.

    python -m benchmark.spans --workload <name> --seed <n> --seconds <s>

The program marks the parts of its serving and train steps with
``torch.profiler.record_function`` ranges while a profiler records
(``polyphonicformer_torch/utils/profiling.py::span``): ``serve/``,
``model/`` and ``train/`` names, each step's spans nested under its root,
``serve/step`` or ``train/step``.  :func:`attribute` reads them beside the
CUDA runtime calls that launched each kernel, copy and set (matched by
correlation id) and the device's intervals:

* per span name: calls, host ms (inclusive and self: less its children's),
  the launches made inside it, their device ms, and the idle ms of the gaps
  in the union of device intervals that its launches ended.  A launch
  belongs to the innermost span open on its thread; where that thread has
  none open (the autograd engine's thread in the backward), to the innermost
  span open on the step's thread at that moment;
* per group, the child of the root span open on the step's thread at the
  launch: idle ms.  ``(step)`` holds launches inside a root but in none of
  its children, ``(outside)`` those outside every span and the window's
  tail after the last kernel.  The groups' idle sums to the window's idle.

:data:`METRICS` are six per-layer readings of those groups, per frame or
sample.  The command runs a cell as ``python -m benchmark.run ... --trace 1``
does, and after its two profiled passes a third over as many steps, with
CPU and CUDA activity and no shapes (the first pass records no host spans);
it prints the cell's lines, then whether the process built the kernels, the
per-span table, and one JSON line with the readings and the groups' idle.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

PREFIXES = ("serve/", "model/", "train/")
ROOTS = ("serve/step", "train/step")
STEP, OUTSIDE = "(step)", "(outside)"
WINDOW = "benchmark.span_pass"

CLIP_PATH = ("serve/fuse", "serve/detections", "serve/track_embeds", "serve/track",
             "serve/render", "serve/stack")
FORWARD = ("train/prep", "train/cast", "train/forward_losses")
BACKWARD = ("train/backward",)
UPDATE = ("train/grad_cast", "train/reduce", "train/clip", "train/optimizer", "train/guard")
# name -> (kind, "idle" ms of the groups or "host" ms of the spans, the root's children)
METRICS = {
    "clip_path_host_ms.serve": ("serve", "host", CLIP_PATH),
    "clip_path_idle_ms.serve": ("serve", "idle", CLIP_PATH),
    "network_idle_ms.serve": ("serve", "idle", ("serve/network",)),
    "forward_idle_ms.train": ("train", "idle", FORWARD),
    "backward_idle_ms.train": ("train", "idle", BACKWARD),
    "update_idle_ms.train": ("train", "idle", UPDATE),
}


class Span(NamedTuple):
    name: str
    thread: int
    start: float  # us
    end: float


class Launch(NamedTuple):
    """A runtime call that put work on the card."""
    corr: int
    thread: int
    ts: float


class Kernel(NamedTuple):
    """A kernel, copy or set on the card, with its launch's correlation id."""
    corr: int
    start: float
    end: float


class Reading(NamedTuple):
    rows: dict  # span name, STEP or OUTSIDE -> calls, host_ms, self_ms, launches, device_ms, idle_ms
    groups: dict  # child of a root, STEP or OUTSIDE -> idle ms
    window_ms: float
    busy_ms: float
    idle_ms: float


def _row() -> dict:
    return dict(calls=0, host_ms=0.0, self_ms=0.0, launches=0, device_ms=0.0, idle_ms=0.0)


def _open_stacks(spans, times):
    """For each time, the tuple of span names open at it (outermost first):
    a span is open over [start, end).  The spans are those of one thread,
    so they nest."""
    points = [(s.start, 1, i) for i, s in enumerate(spans)]
    points += [(s.end, 0, i) for i, s in enumerate(spans)]
    points += [(t, 2, i) for i, t in enumerate(times)]
    stack, out = [], [()] * len(times)
    for _, kind, i in sorted(points):
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            stack.remove(i)
        else:
            out[i] = tuple(spans[j].name for j in stack)
    return out


def _host_times(spans, rows) -> None:
    """Calls and inclusive and self host ms of each span (one thread's)."""
    stack = []
    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            stack.pop()
        row = rows.setdefault(s.name, _row())
        row["calls"] += 1
        row["host_ms"] += (s.end - s.start) / 1e3
        row["self_ms"] += (s.end - s.start) / 1e3
        if stack:
            rows[stack[-1].name]["self_ms"] -= (s.end - s.start) / 1e3
        stack.append(s)


def attribute(spans, launches, kernels, window) -> Reading:
    """The per-span rows and the groups' idle of one profiled window
    ``(t0, t1)`` (us), as the module's docstring says."""
    t0, t1 = window
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
    roots = sorted((s for s in spans if s.name in ROOTS), key=lambda s: s.start)
    main = roots[0].thread if roots else None
    rows = {}
    for own in by_thread.values():
        _host_times(own, rows)
    rows[STEP], rows[OUTSIDE] = _row(), _row()

    main_stacks = _open_stacks(by_thread.get(main, []), [c.ts for c in launches])
    own_stacks = [()] * len(launches)
    for thread, own in by_thread.items():
        idx = [i for i, c in enumerate(launches) if c.thread == thread]
        for i, st in zip(idx, _open_stacks(own, [launches[i].ts for i in idx])):
            own_stacks[i] = st
    where = {}  # corr -> (span for the rows, group)
    for c, own, st in zip(launches, own_stacks, main_stacks):
        roots_in = [k for k, n in enumerate(st) if n in ROOTS]
        group = OUTSIDE if not roots_in else (
            st[roots_in[0] + 1] if len(st) > roots_in[0] + 1 else STEP)
        inner = own or st
        name = inner[-1] if inner else OUTSIDE
        if name in ROOTS:
            name = STEP
        where[c.corr] = (name, group)

    groups = {}
    inside = sorted((max(k.start, t0), min(k.end, t1), k.corr) for k in kernels
                    if k.end > t0 and k.start < t1)
    busy, end = 0.0, t0
    for s, e, corr in inside:
        name, group = where.get(corr, (OUTSIDE, OUTSIDE))
        row = rows[name]
        row["launches"] += 1
        row["device_ms"] += (e - s) / 1e3
        if s > end:
            row["idle_ms"] += (s - end) / 1e3
            groups[group] = groups.get(group, 0.0) + (s - end) / 1e3
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    if t1 > end:
        rows[OUTSIDE]["idle_ms"] += (t1 - end) / 1e3
        groups[OUTSIDE] = groups.get(OUTSIDE, 0.0) + (t1 - end) / 1e3
    window_ms = (t1 - t0) / 1e3
    return Reading(rows=rows, groups=groups, window_ms=window_ms, busy_ms=busy / 1e3,
                   idle_ms=window_ms - busy / 1e3)


def metrics(reading: Reading, kind: str, units: int) -> dict:
    """:data:`METRICS` of ``kind`` over ``units`` frames or samples; none
    where no ``<kind>/step`` span was recorded (a program without spans)."""
    out = {}
    if not units or not reading.rows.get(f"{kind}/step", {}).get("calls"):
        return out
    for name, (k, what, children) in METRICS.items():
        if k != kind:
            continue
        if what == "host":
            ms = sum(reading.rows[c]["host_ms"] for c in children if c in reading.rows)
        else:
            ms = sum(reading.groups.get(c, 0.0) for c in children)
        out[name] = ms / units
    return out


def _is_runtime(name: str) -> bool:
    return name.startswith("cu") and "::" not in name


def from_profile(prof):
    """(spans, launches, kernels, window) of a ``torch.profiler`` profile
    with CPU and CUDA activity whose steps ran inside a
    ``record_function(WINDOW)``.  A runtime call's thread is that of the
    host op that made it (its linked correlation id), else its own."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, ops, calls, kernels, window = [], {}, [], [], None
    for e in events:
        name = e.name()
        start, end = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append(Kernel(e.correlation_id(), start, end))
        elif _is_runtime(name):
            calls.append((e, start))
        else:
            ops[e.correlation_id()] = e.start_thread_id()
            if name.startswith(PREFIXES):
                spans.append(Span(name, e.start_thread_id(), start, end))
            elif name == WINDOW:
                window = (start, end)
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW} range")
    launches = [Launch(e.correlation_id(), ops.get(e.linked_correlation_id(),
                                                   e.start_thread_id()), ts)
                for e, ts in calls]
    return spans, launches, kernels, window


def span_pass(run_step, n: int, sync):
    """``n`` steps under ``torch.profiler`` with CPU and CUDA activity, in a
    ``record_function(WINDOW)`` closed by ``sync()``: (profile, seconds on
    the host clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(n):
                run_step()
            sync()
        seconds = time.perf_counter() - t0
    return prof, seconds


def table_lines(reading: Reading, steps: int) -> list:
    """One line per span, most idle first, each number per step."""
    lines = [f"spans per step over {steps}: calls, host ms (self), launches, device ms, "
             f"idle ms"]
    for name, r in sorted(reading.rows.items(), key=lambda kv: -kv[1]["idle_ms"]):
        if r["calls"] or r["launches"]:
            lines.append(f"span {name}: {r['calls'] / steps:g}, {r['host_ms'] / steps:.3f} "
                         f"({r['self_ms'] / steps:.3f}), {r['launches'] / steps:g}, "
                         f"{r['device_ms'] / steps:.3f}, {r['idle_ms'] / steps:.3f}")
    return lines


def kernels_line() -> str:
    """Whether this process built the port's CUDA kernels or loaded them."""
    from polyphonicformer_torch.ops.cuda import _lib

    if _lib.build_seconds is not None:
        return f"kernels: built in this process in {_lib.build_seconds:.1f} s"
    return "kernels: loaded from the build cache"


def main(argv=None) -> int:
    from . import cells, run, trace as tracing

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    got = {}
    two_passes = tracing.profile_steps

    def three_passes(run_step, n, sync):
        out = two_passes(run_step, n, sync)
        got["device_pass_spans"] = sum(
            e.name().startswith(PREFIXES) for e in out[0].profiler.kineto_results.events())
        got["prof"], got["seconds"] = span_pass(run_step, n, sync)
        return out

    tracing.profile_steps = three_passes
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        tracing.profile_steps = two_passes
    if rc != 0 or "prof" not in got:
        return rc or 1
    steps = int(cell.mix["profile_steps"])
    kind = "serve" if cell.mix["entry"] == "serve_batched" else "train"
    units = steps * int(cell.mix["streams"] if kind == "serve" else cell.config["batch_size"])
    spans, launches, kernels, window = from_profile(got["prof"])
    reading = attribute(spans, launches, kernels, window)
    values = metrics(reading, kind, units)
    print(kernels_line())
    print(f"span pass: {steps} steps in {got['seconds']:.6f} s, "
          f"{1e3 * got['seconds'] / steps:.3f} ms a step; program spans in the device "
          f"pass: {got['device_pass_spans']}")
    for line in table_lines(reading, steps):
        print(line)
    corrs = {c.corr for c in launches}
    matched = sum(k.corr in corrs for k in kernels)
    top = sorted(reading.rows.items(), key=lambda kv: -kv[1]["idle_ms"])[:10]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "steps": steps, "units": units,
        "span_pass_step_ms": 1e3 * got["seconds"] / steps, "window_ms": reading.window_ms,
        "busy_ms": reading.busy_ms, "idle_ms": reading.idle_ms,
        "groups_idle_ms": reading.groups, "groups_sum_ms": sum(reading.groups.values()),
        "kernels": len(kernels), "kernels_matched": matched,
        "threads": sorted({c.thread for c in launches}), "metrics": values,
        "spans": [[n, r["idle_ms"]] for n, r in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
