"""The card's idle time put down to the program's spans.

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

The benchmark's traced runs (``python -m benchmark.run ... --trace 1``)
make a third profiled pass for them (``trace.profile_steps``) and print the
per-span table and the groups' idle; the per-layer metrics that read them
are files of ``benchmark/metrics`` naming their spans
(``metrics/_common.py::span_ms``).
"""
from __future__ import annotations

from typing import NamedTuple

PREFIXES = ("serve/", "model/", "train/")
ROOTS = ("serve/step", "train/step")
STEP, OUTSIDE = "(step)", "(outside)"
WINDOW = "benchmark.span_pass"


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
    """The profile of ``n`` steps under ``torch.profiler`` with CPU and CUDA
    activity, in a ``record_function(WINDOW)`` closed by ``sync()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                run_step()
            sync()
    return prof


def table_lines(reading: Reading, steps: int) -> list:
    """One line per span, most idle first, then the groups' idle, each
    number per step."""
    lines = [f"spans per step over {steps} ({reading.window_ms / steps:.3f} ms a step): "
             f"calls, host ms (self), launches, device ms, idle ms"]
    for name, r in sorted(reading.rows.items(), key=lambda kv: -kv[1]["idle_ms"]):
        if r["calls"] or r["launches"]:
            lines.append(f"span {name}: {r['calls'] / steps:g}, {r['host_ms'] / steps:.3f} "
                         f"({r['self_ms'] / steps:.3f}), {r['launches'] / steps:g}, "
                         f"{r['device_ms'] / steps:.3f}, {r['idle_ms'] / steps:.3f}")
    groups = sorted(reading.groups.items(), key=lambda kv: -kv[1])
    lines.append("span groups, idle ms: " + ", ".join(f"{g} {ms / steps:.3f}"
                                                      for g, ms in groups))
    return lines


def kernels_line() -> str:
    """Whether this process built the port's CUDA kernels or loaded them."""
    from polyphonicformer_torch.ops.cuda import _lib

    if _lib.build_seconds is not None:
        return f"kernels: built in this process in {_lib.build_seconds:.1f} s"
    return "kernels: loaded from the build cache"

