"""Serving entry: the port's ``make_batched_video_step`` over B camera
streams, one frame of each a step, each stream with its own tracker state.

The loop is closed: a stream's next frame needs its tracker state from the
last, so each step waits for its outputs (``torch.cuda.synchronize``)
before the next is submitted.  Set-up builds the model from the seed, makes
the frame pool on the card and runs ``warm_steps`` steps on tracker states
of their own.  The window then starts every stream at frame 0 from a fresh
state and runs whole steps until ``--seconds`` have passed.

For the check, steps ``0 .. check_first_steps - 1`` and
``check_sampled_steps`` steps drawn from the seed below
``check_sample_below`` are kept: the kernel head's dense depth, each update
stage's inputs and outputs and the track embeddings (forward hooks on the
served model, which keep them only when a kept step runs), the tracker
states the step took and gave, and the four maps.  They are copied to the host after the
step's latency is taken; the copies count in the window's seconds.
"""
from __future__ import annotations

import dataclasses
import random
import statistics
import time

import torch

from .. import device as devices, program, spans, trace as tracing, weights
from ..check import serve as check
from ..reference import config as ref_config
from ..roofline import model_flops
from ..traffic import moving_blocks


class _Capture:
    """Forward hooks that keep the outputs of one step when armed: the
    kernel head's, each update stage's inputs and outputs, and the track
    embeddings."""

    def __init__(self, model):
        self.armed, self.got = False, {}
        self.handles = [
            model.rpn_head.register_forward_hook(self._keep("rpn")),
            model.track_head.register_forward_hook(self._keep("embeds"))]
        for s, head in enumerate(model.roi_head.mask_head):
            self.handles.append(head.register_forward_hook(self._keep(("stage", s)),
                                                           with_kwargs=True))

    def _keep(self, key):
        def hook(_module, *args_out):
            if self.armed:
                self.got[key] = args_out
        return hook

    def take(self) -> dict:
        """The kept outputs on the host (:func:`check.serve.outputs`, with
        ``embeds``), each tensor copied once; disarms."""
        g, self.got, self.armed = self.got, {}, False
        host = {}

        def cpu(t):
            if id(t) not in host:
                host[id(t)] = t.cpu()
            return host[id(t)]

        stages = [g[k] for k in sorted(k for k in g if isinstance(k, tuple))]
        out = check.outputs(g["rpn"][-1].depth_pred, stages, to=cpu)
        out["embeds"] = cpu(g["embeds"][-1])
        return out

    def close(self):
        for h in self.handles:
            h.remove()


def _state_cpu(state):
    return {f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)}


def setup_marks(started: float, marks) -> str:
    """Set-up's seconds by part: each mark's time since the one before."""
    last, parts = started, []
    for name, t in marks:
        parts.append(f"{name} {t - last:.2f}")
        last = t
    return "setup: " + ", ".join(parts) + " s"


def latency_line(lat, issue) -> str:
    """The steps' latencies by quantile, and how many of them the host paced:
    steps whose call returned after 90% or more of the latency had passed."""
    if len(lat) < 2:
        return "latency: too few steps"
    q = statistics.quantiles([1e3 * x for x in lat], n=100)
    paced = sum(i >= 0.9 * x for i, x in zip(issue, lat))
    return (f"latency ms: p50 {q[49]:.1f}, p90 {q[89]:.1f}, p95 {q[94]:.1f}, p99 {q[98]:.1f}, "
            f"max {1e3 * max(lat):.1f}; host-paced steps {paced} of {len(lat)}, "
            f"call returned at p50 {1e3 * statistics.median(issue):.1f} ms")


def check_steps(mix: dict, seed: int) -> list[int]:
    first = int(mix["check_first_steps"])
    rng = random.Random(seed)
    pool = range(first, int(mix["check_sample_below"]))
    return sorted(set(range(first)) | set(rng.sample(pool, int(mix["check_sampled_steps"]))))


def run(ctx):
    from polyphonicformer_torch.infer.pipeline import (init_batched_tracker_states,
                                                       make_batched_video_step)
    from polyphonicformer_torch.models import build_model

    from ..run import Result

    cell, dev, mix = ctx.cell, ctx.device, ctx.cell.mix
    cfg = program.experiment(cell.config)
    exp = ref_config.experiment(cell.config)
    hw = tuple(cell.config["image_hw"])
    streams = int(mix["streams"])
    dtypes = {k: getattr(torch, v) for k, v in cell.config["serve"].items()}
    program.set_tf32(False)

    marks = [("imports", time.time())]
    sd = weights.state_dict(exp, ctx.seed, dev, zero_class_bias=bool(mix["zero_class_bias"]))
    model = build_model(cfg.model, dev, state_dict=sd)
    step = make_batched_video_step(model, cfg.model, hw, compute_dtype=dtypes["compute_dtype"],
                                   fusion_dtype=dtypes["fusion_dtype"])
    served = step.args[0]
    del model
    devices.sync(dev)
    marks.append(("model", time.time()))
    frames = moving_blocks.pool(mix, hw, ctx.seed, dev)
    cycle = frames.shape[0]
    capture = _Capture(served)
    devices.sync(dev)
    marks.append(("frames", time.time()))

    states = init_batched_tracker_states(cfg.model, streams, dev)
    for t in range(int(mix["warm_steps"])):
        _, states = step(frames[t % cycle], states, [t] * streams)
    devices.sync(dev)
    keep = check_steps(mix, ctx.seed)
    kept = {}
    prof_steps = int(mix["profile_steps"])
    flops = model_flops.step_flops(str(cell.config_path), "serve", streams) \
        if ctx.trace else 0.0

    loop = {"t": 0, "states": init_batched_tracker_states(cfg.model, streams, dev),
            "end": 0.0}
    lat, issue = [], []  # a step's seconds to outputs complete; to the call's return

    def serve_one():
        t, state_in = loop["t"], loop["states"]
        capture.armed = t in keep
        now = time.perf_counter()
        out, loop["states"] = step(frames[t % cycle], state_in, [t] * streams)
        issued = time.perf_counter()
        devices.sync(dev)
        loop["end"] = time.perf_counter()
        lat.append(loop["end"] - now)
        issue.append(issued - now)
        if t in keep:
            kept[t] = {"heads": capture.take(), "state_in": _state_cpu(state_in),
                       "state_out": _state_cpu(loop["states"]),
                       "maps": {k: getattr(out, k).cpu()
                                for k in ("semantic", "panoptic", "track_map", "depth")}}
        loop["t"] = t + 1

    devices.sync(dev)
    devices.reset_peak(dev)
    setup_s = time.time() - ctx.started
    marks.append(("warm", time.time()))
    start = time.perf_counter()
    deadline = start + ctx.seconds
    profiled = None
    while time.perf_counter() < deadline:
        if ctx.trace and profiled is None and time.perf_counter() - start >= ctx.seconds / 2:
            profile_at = loop["t"]
            profiled = tracing.profile_steps(serve_one, prof_steps, lambda: devices.sync(dev))
        else:
            serve_one()
    window_s = loop["end"] - start
    peak = devices.peak_bytes(dev)
    capture.close()
    steps = loop["t"]
    frames_done = steps * streams
    lat_sorted = sorted(lat)
    p95 = lat_sorted[min(len(lat) - 1, int(0.95 * len(lat)))] if lat else float("nan")
    notes = [f"window: {steps} steps, {frames_done} frames in {window_s:.3f} s; "
             f"frame_p95_ms over {len(lat)} step latencies",
             latency_line(lat, issue), setup_marks(ctx.started, marks),
             spans.kernels_line()]
    trace, breakdown = None, None
    if ctx.trace:
        trace, breakdown = tracing.read(*profiled, "serve", prof_steps, prof_steps * streams,
                                        0, flops, cell.config["serve"]["compute_dtype"])
        notes.append(f"profiled: steps {profile_at}..{profile_at + prof_steps - 1} "
                     f"({trace.span_s:.6f} s), shapes over the next {prof_steps}, "
                     f"spans over the {prof_steps} after")
        notes += spans.table_lines(trace.spans, prof_steps)
    del step, served, loop, capture
    devices.empty_cache(dev)
    checks, failed, more = check.compare(exp, cell, sd, frames, kept, keep, dev, dtypes)
    notes += more
    e2e = {"frames_per_s": frames_done / window_s, "frame_p95_ms": 1e3 * p95,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return Result(setup_s=setup_s, attempted=frames_done, failed=failed, end_to_end=e2e,
                  memory_peak_bytes=peak, checks=checks, trace=trace, breakdown=breakdown,
                  notes=notes)
