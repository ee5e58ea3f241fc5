"""What decides ``correct`` in a training cell.

The reference (``benchmark/reference``) builds the model from the same state
dict, its own AdamW and its own train step (a bf16 copy refreshed from f32
master weights where the configuration computes in bf16), and follows the
program's first steps on the same batches.  A matching is a discrete choice
that rounding can flip between two near-equal assignments, which moves a
stage's losses by 0.4-2%; so the reference solves every Hungarian problem
on its own costs and then takes the program's matching (it follows the
program's state there), and the matching is judged by its cost:

* ``matching_gap``: the program's assignment's cost under the reference's
  costs above the optimal assignment's, over the problem's valid rows
  times the spread of its costs (0 for the same assignment, rounding for a
  flip between near-equal ones; an assignment that leaves a valid row
  unassigned or takes a column twice reads 1);

* ``loss_gap``: every loss term and ``total_loss`` of every followed step,
  the worst ``|program - reference| / max(|reference|, 1e-3)``;
* ``grad_norm_gap``: each step's gradient norm before the clip, relative;
* ``first_grad_gap``: the first gradient of each leaf as AdamW holds it
  after step 1; the worst gap of the two norms over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap``: each leaf's change over the followed steps, the same way;
* ``first_grad_median_gap``, ``change_median_gap``: the median leaf's gap of
  each, steady where rounding moves single small leaves far (bf16).

A cell's limits file names the numbers it compares; the others are printed.

Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone under Adam and are left out of both leaf gaps.
"""
from __future__ import annotations

import statistics

import torch

from ..reference import kernels
from ..reference.data.structures import GTSample, TrainBatch
from ..reference.models.polyphonic import build_model
from ..reference.ops import hungarian
from ..reference.train.step import create_train_state, make_train_step
from . import lowp

BETA1 = 0.9
LOSS_FLOOR = 1e-3
ROUNDOFF_LEAF = 1e-3


def reference_batch(parts) -> TrainBatch:
    image, gt, ref_image, ref_gt = parts
    return TrainBatch(image=image, gt=GTSample(**gt), ref_image=ref_image,
                      ref_gt=None if ref_gt is None else GTSample(**ref_gt))


def _norms(names, tensors) -> dict:
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors])).cpu().tolist()
    return dict(zip(names, norms))


def cost_gap(costs: torch.Tensor, valid: torch.Tensor, taken: torch.Tensor,
             best: torch.Tensor) -> float:
    """The worst problem's cost of ``taken`` above ``best`` (both (N, G)
    columns of valid rows), over its valid rows times its costs' spread."""
    cost = torch.nan_to_num(costs.float(), nan=1e8, posinf=1e8, neginf=-1e8).cpu().double()
    valid, taken, best = valid.cpu(), taken.cpu().long(), best.cpu().long()
    worst = 0.0
    for n in range(cost.shape[0]):
        rows = valid[n].nonzero()[:, 0]
        if not len(rows):
            continue
        cols = taken[n, rows]
        if (cols < 0).any() or (cols >= cost.shape[2]).any() or cols.unique().numel() < len(rows):
            return 1.0
        c = cost[n, rows]
        spread = (c.max() - c.min()).item()
        diff = (c.gather(1, cols[:, None]).sum() - c.gather(1, best[n, rows][:, None]).sum())
        worst = max(worst, diff.item() / max(len(rows) * spread, 1e-30))
    return worst


class _Follow:
    """The reference's Hungarian solve: its own optimum on its own costs,
    then the followed side's answer taken in its place (``force``), the
    cost gap kept; without ``force`` its own answers, kept."""

    def __init__(self, force=None):
        self.force, self.answers, self.gaps = force, [], []

    def __call__(self, costs, valid):
        own = kernels.solve_lsa(costs, valid)
        self.answers.append(own.cpu())
        if self.force is None:
            return own
        i = len(self.answers) - 1
        if i >= len(self.force) or self.force[i].shape != own.shape:
            self.gaps.append(1.0)  # the followed side solved other problems
            return own
        taken = self.force[i].to(own.device)
        self.gaps.append(cost_gap(costs, valid, taken, own))
        return taken


def reference_readings(exp, sd, parts, n: int, dev, steps_per_epoch: int,
                       precision: str | None = None, force=None) -> dict:
    """The reference's readings of ``n`` steps.  ``precision``: "tf32"
    computes the f32 convolutions and products in TF32, "fp8" rounds the
    bf16 copy's convolution and linear operands to float8 (the controls).
    ``force``: the matchings of the side it follows, in solve order."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    follow = _Follow(force)
    hungarian.solve_lsa = follow
    try:
        model = build_model(exp.model, sd, dev)
        state, opt = create_train_state(model, exp, steps_per_epoch, device=dev)
        step = make_train_step(state.model, exp, opt, video=parts[0][2] is not None,
                               prepare=lowp.fake_quant_ if precision == "fp8" else None)
        batches = [reference_batch(p) for p in parts]
        params = list(opt.params)
        names = [opt.names[id(p)] for p in params]
        start = [p.detach().clone() for p in params]
        losses, first_grad = [], None
        for i in range(n):
            state, metrics = step(state, batches[i % len(batches)])
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                first_grad = _norms(names, [opt.adamw.state[p]["exp_avg"] / (1 - BETA1)
                                            for p in params])
        change = _norms(names, [p.detach() - s for p, s in zip(params, start)])
    finally:
        hungarian.solve_lsa = kernels.solve_lsa
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if force is not None and len(follow.answers) != len(force):
        follow.gaps.append(1.0)
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "matchings": follow.answers, "matching_gap": max(follow.gaps, default=0.0)}


def _leaf_gaps(got: dict, ref: dict, grads: dict) -> dict:
    med_grad = statistics.median(grads.values())
    kept = [k for k in ref if grads[k] >= ROUNDOFF_LEAF * med_grad]
    med = statistics.median(ref[k] for k in kept)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in kept}


def _worst(gaps: dict) -> tuple[float, str]:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def gaps(got: dict, ref: dict) -> dict:
    """The four compared numbers of two sets of readings, and where the
    worst of each lies."""
    loss, where = 0.0, ""
    gnorm = 0.0
    for i, (p, r) in enumerate(zip(got["losses"], ref["losses"])):
        for k, rv in r.items():
            if k == "grad_norm":
                gnorm = max(gnorm, abs(p[k] - rv) / max(abs(rv), 1e-30))
            elif k.startswith("loss") or k == "total_loss":
                g = abs(p[k] - rv) / max(abs(rv), LOSS_FLOOR)
                if g > loss:
                    loss, where = g, f"step {i + 1} {k}"
    first = _leaf_gaps(got["first_grad"], ref["first_grad"], ref["first_grad"])
    change = _leaf_gaps(got["change"], ref["change"], ref["first_grad"])
    return {"matching_gap": (ref["matching_gap"], ""), "loss_gap": (loss, where),
            "grad_norm_gap": (gnorm, ""), "first_grad_gap": _worst(first),
            "first_grad_median_gap": (statistics.median(first.values()), ""),
            "change_gap": _worst(change),
            "change_median_gap": (statistics.median(change.values()), "")}


def compare(exp, cell, sd, parts, got: dict, dev):
    """The checks of a training run: ([(name, value, limit)], notes)."""
    mix = cell.mix
    ref = reference_readings(exp, sd, parts, len(got["losses"]), dev,
                             int(mix["steps_per_epoch"]), force=got["matchings"])
    flips = sum(int((a != b).sum()) if a.shape == b.shape else b.numel()
                for a, b in zip(got["matchings"], ref["matchings"]))
    found = gaps(got, ref)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    notes = [f"check: {k} at {v[1]}" for k, v in found.items() if v[1] and k in limits]
    notes.append("check: not compared " + ", ".join(
        f"{k}={v[0]!r}" for k, v in found.items() if k not in limits))
    notes.append(f"check: {flips} matched rows differ from the reference's own optimum")
    notes.append("check: total_loss program " +
                 " ".join(f"{s['total_loss']:.6f}" for s in got["losses"]) + " reference " +
                 " ".join(f"{s['total_loss']:.6f}" for s in ref["losses"]))
    return [(k, found[k][0], limits[k]) for k in limits], notes
