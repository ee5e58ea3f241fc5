"""Training entry: the port's ``make_train_step(video=True)`` on a state
from ``create_train_state``, over a pool of seeded 2-frame batches cycled
step by step.

Set-up builds the model from the seed and drives the step through its first
``reference_steps`` steps on pool batches 0, 1, 2, ... (all different rows):
they warm up every shape and are the steps the reference follows.  Read
from them: each step's losses and ``grad_norm``, the first gradient of every
leaf as AdamW holds it after step 1 (``exp_avg / (1 - beta1)``), every
leaf's change over the steps, and every matching the program's Hungarian
solve returned (a wrapper of ``ops.hungarian.solve_lsa`` keeps a copy over
these steps only).  The window then continues the same state
and the same call; it ends with a synchronize after the last step that
started before ``--seconds`` had passed.
"""
from __future__ import annotations

import time

import torch

from .. import device as devices, program, spans, trace as tracing, weights
from ..check import train as check
from .serve_batched import setup_marks
from ..reference import config as ref_config
from ..roofline import model_flops
from ..traffic import synthetic_batch

BETA1 = 0.9


def leaf_norms(names, tensors) -> dict:
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors])).cpu().tolist()
    return dict(zip(names, norms))


class _Recorded:
    """The program's Hungarian solve, its every answer kept (a copy); in
    place only over the followed steps."""

    def __init__(self, solve):
        self.solve, self.answers = solve, []

    def __call__(self, costs, valid):
        out = self.solve(costs, valid)
        self.answers.append(out.clone())
        return out


def readings(step, state, opt, batches, n: int):
    """Drive ``n`` steps; returns (state, readings of check.train): each
    step's metrics, the first gradient and the change of every leaf, and
    every matching the program solved."""
    from polyphonicformer_torch.ops import hungarian

    params = list(opt.params)
    names = [opt.names[id(p)] for p in params]
    start = [p.detach().clone() for p in params]
    losses, first_grad = [], None
    recorded = _Recorded(hungarian.solve_lsa)
    hungarian.solve_lsa = recorded
    try:
        for i in range(n):
            state, metrics = step(state, batches[i % len(batches)])
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                first_grad = leaf_norms(names, [opt.adamw.state[p]["exp_avg"] / (1 - BETA1)
                                                for p in params])
    finally:
        hungarian.solve_lsa = recorded.solve
    change = leaf_norms(names, [p.detach() - s for p, s in zip(params, start)])
    return state, {"losses": losses, "first_grad": first_grad, "change": change,
                   "matchings": [a.cpu() for a in recorded.answers]}


def run(ctx):
    from polyphonicformer_torch.models import build_model
    from polyphonicformer_torch.train.step import create_train_state, make_train_step

    from ..run import Result

    cell, dev, mix = ctx.cell, ctx.device, ctx.cell.mix
    cfg = program.experiment(cell.config)
    exp = ref_config.experiment(cell.config)
    hw = tuple(cell.config["image_hw"])
    batch = int(cell.config["batch_size"])
    program.set_tf32(bool(cell.config["train"]["tf32"]))

    marks = [("imports", time.time())]
    sd = weights.state_dict(exp, ctx.seed, dev)
    model = build_model(cfg.model, dev, state_dict=sd)
    state, opt = create_train_state(model, cfg, None, int(mix["steps_per_epoch"]), device=dev)
    step = make_train_step(state.model, cfg, opt, video=bool(mix["two_frame"]))
    devices.sync(dev)
    marks.append(("model", time.time()))
    parts = synthetic_batch.pool(mix, exp.model, batch, hw, ctx.seed, dev)
    batches = [program.train_batch(p) for p in parts]
    marks.append(("batches", time.time()))
    n_ref = int(mix["reference_steps"])
    state, got = readings(step, state, opt, batches, n_ref)
    flops = model_flops.step_flops(str(cell.config_path), "train", batch) if ctx.trace else 0.0

    devices.sync(dev)
    devices.reset_peak(dev)
    setup_s = time.time() - ctx.started
    marks.append(("steps", time.time()))
    prof_steps = int(mix["profile_steps"])
    loop = {"i": n_ref, "state": state}
    del state

    def train_one():
        loop["state"], _ = step(loop["state"], batches[loop["i"] % len(batches)])
        loop["i"] += 1

    start = time.perf_counter()
    deadline = start + ctx.seconds
    profiled = None
    while time.perf_counter() < deadline:
        if ctx.trace and profiled is None and time.perf_counter() - start >= ctx.seconds / 2:
            profile_at = loop["i"]
            profiled = tracing.profile_steps(train_one, prof_steps, lambda: devices.sync(dev))
        else:
            train_one()
    devices.sync(dev)
    window_s = time.perf_counter() - start
    peak = devices.peak_bytes(dev)
    steps = loop["i"] - n_ref
    notes = [f"window: {steps} steps, {steps * batch} samples in {window_s:.3f} s",
             setup_marks(ctx.started, marks), spans.kernels_line()]
    trace, breakdown = None, None
    if ctx.trace:
        trace, breakdown = tracing.read(*profiled, "train", prof_steps, 0, prof_steps * batch,
                                        flops, cell.config["train"]["compute_dtype"])
        notes.append(f"profiled: steps {profile_at}..{profile_at + prof_steps - 1} "
                     f"({trace.span_s:.6f} s), shapes over the next {prof_steps}, "
                     f"spans over the {prof_steps} after")
        notes += spans.table_lines(trace.spans, prof_steps)
    del step, loop, opt, model
    devices.empty_cache(dev)
    checks, more = check.compare(exp, cell, sd, parts, got, dev)
    notes += more
    e2e = {"train_samples_per_s": steps * batch / window_s, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}
    failed = 0 if all(v is not None and v <= lim for _, v, lim in checks) else n_ref * batch
    return Result(setup_s=setup_s, attempted=steps * batch, failed=failed, end_to_end=e2e,
                  memory_peak_bytes=peak, checks=checks, trace=trace, breakdown=breakdown,
                  notes=notes)
