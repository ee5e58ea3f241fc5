"""What decides ``correct`` in a serving cell.

Kept steps of the window (``entries/serve_batched.py``) are judged against
the plain reference (``benchmark/reference``), built from the same state
dict and fed the same frames:

* ``rpn_rel_err``: the backbone (with its window attention), the FPN and
  the kernel head, run by the reference over the step's frames in the
  configuration's compute dtype: the relative L2 gap of each dense output
  that the update stages or the fusion read (the features, the depth
  features, the mask logits, the dense depth), and of the first stage's
  queries, which the reference pools (K1) from the program's own mask
  logits and features.  The worst part over the kept steps.
* ``stages_rel_err``: each update stage, run by the reference on the very
  inputs the program gave that stage (its queries, mask logits, depth
  kernels and features), so the reference follows the program stage by
  stage: a mask pixel that rounding moves across the hard-mask threshold
  moves whole queries of every later stage through their attention, and
  a reference that ran on its own logits would judge that swing and not
  the stage (PERF.md).  The relative L2 gap of each output the next stage
  or the fusion reads; the worst over stages, outputs and kept steps.
* ``embeds_rel_err``: the track head's RoIAlign embeddings, taken by the
  reference from its own features at the same boxes; relative L2 gap over
  the valid detections (0 in a step without any).
* ``maps_mismatch``, ``depth_rel_err``, ``state_err``: the x2 upsample,
  fusion, detections and boxes, tracker and map render, run by the
  reference from the program's network outputs, its track embeddings and
  the tracker state the program carried into the step (so the reference
  follows the program step by step from its own state; steps 0 and 1 start
  from the fresh state and check the carry from the start).  The share of
  pixels of the semantic, panoptic and track maps that differ, the depth
  map's worst gap over its largest value, and the tracker state's worst gap
  (an integer field that differs counts 1).
"""
from __future__ import annotations

import dataclasses

import torch

from ..reference.infer import pipeline as rp
from ..reference.infer.tracker import TrackerState
from ..reference.models.polyphonic import build_model
from . import lowp


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.to(r.device).double(), r.double()
    den = torch.linalg.vector_norm(r).item()
    return torch.linalg.vector_norm(p - r).item() / max(den, 1e-30)


def _heads_of(got: dict, dev) -> rp._Heads:
    up = rp._upsample2
    last = got["stages"][-1]["out"]
    return rp._Heads(cls_probs=torch.sigmoid(last["cls_score"].to(dev).float()),
                     mask_logits=up(last["mask_preds"].to(dev).float()),
                     depth_logits=up(last["depth_preds"].to(dev).float()),
                     depth_init=up(got["depth_pred"].to(dev).float()))


def _state(d: dict, b: int, dev) -> TrackerState:
    return TrackerState(**{k: v[b].to(dev) for k, v in d.items()})


def state_gap(p: TrackerState, r: TrackerState) -> float:
    worst = 0.0
    for f in dataclasses.fields(TrackerState):
        a, b = getattr(p, f.name), getattr(r, f.name)
        if a.dtype.is_floating_point:
            worst = max(worst, ((a.double() - b.double()).abs().max().item()
                                / (1.0 + b.double().abs().max().item())) if a.numel() else 0.0)
        elif not torch.equal(a, b):
            worst = max(worst, 1.0)
    return worst


def reference_network(exp, sd, dev, dtype, precision: str | None = None):
    """The reference model in ``dtype``; ``precision`` "fp8" rounds every
    convolution's and linear layer's weights and inputs to float8 e4m3 (the
    control)."""
    model = build_model(exp.model, sd, dev).to(dtype)
    if precision == "fp8":
        lowp.fake_quant_(model)
    return model


STAGE_OUT = ("cls_score", "mask_preds", "obj_feats", "depth_kernels")


def outputs(depth_pred, stages, to=lambda t: t) -> dict:
    """A step's network outputs as the check reads them: the kernel head's
    dense depth and, for each update stage, its inputs (``args``,
    ``kwargs``) and the outputs the next stage or the fusion reads (the
    last stage's depth logits too).  ``stages``: [(args, kwargs, output)];
    ``to`` maps each tensor (the serving entry copies to the host)."""
    last = len(stages) - 1
    return {"depth_pred": to(depth_pred),
            "stages": [{"args": tuple(to(a) for a in args),
                        "kwargs": {k: to(v) for k, v in kwargs.items()},
                        "out": {k: to(getattr(out, k))
                                for k in STAGE_OUT + (("depth_preds",) if s == last else ())}}
                       for s, (args, kwargs, out) in enumerate(stages)]}


@torch.no_grad()
def network_outputs(model, images: torch.Tensor, dtype):
    """(FPN features, :func:`outputs`) of the reference ``model`` on
    ``images``, stage by stage as ``forward_heads`` runs them."""
    fpn = model.extract_feat(images.to(dtype))
    rpn = model.rpn_head(fpn, with_aspp=False)
    stages, pf, mp, dp = [], rpn.proposal_feats, rpn.mask_preds, rpn.depth_proposal
    for head in model.roi_head.mask_head:
        args = (rpn.x_feats, pf, mp, dp, rpn.depth_feats)
        out = head(*args)
        stages.append((args, {}, out))
        pf, mp, dp = out.obj_feats, out.mask_preds, out.depth_kernels
    return fpn, outputs(rpn.depth_pred, stages)


@torch.no_grad()
def network_gaps(model, got: dict, ref: dict, dev) -> dict:
    """The gaps of a step's network outputs ``got`` (the program's, or the
    control's in its place) against the reference ``model``: ``ref`` is
    what ``model`` made of the same frames (:func:`network_outputs`).
    Returns ``rpn_rel_err``, ``stages_rel_err`` and each part's gap."""
    a, r = got["stages"][0]["args"], ref["stages"][0]["args"]
    x, mask_preds = a[0].to(dev), a[2].to(dev)
    nq = model.rpn_head.init_kernels.weight.shape[0]  # the thing queries lead
    parts = {"rpn.x_feats": rel(a[0], r[0]), "rpn.depth_feats": rel(a[4], r[4]),
             "rpn.mask_preds": rel(a[2], r[2]),
             "rpn.depth_pred": rel(got["depth_pred"], ref["depth_pred"]),
             "rpn.queries": rel(a[1], model.rpn_head.queries(mask_preds[:, :nq], x))}
    for s, (head, st) in enumerate(zip(model.roi_head.mask_head, got["stages"])):
        out = head(*(t.to(dev) for t in st["args"]),
                   **{k: v.to(dev) for k, v in st["kwargs"].items()})
        for k, v in st["out"].items():
            parts[f"stage{s}.{k}"] = rel(v, getattr(out, k))
    return {"rpn_rel_err": max(v for k, v in parts.items() if k.startswith("rpn.")),
            "stages_rel_err": max(v for k, v in parts.items() if k.startswith("stage")),
            **parts}


@torch.no_grad()
def detections(exp, got: dict, hw, dev, fusion_dtype):
    """The detections of each stream of a step from its network outputs:
    (valid (B, D), MAD boxes (B, D, 4))."""
    heads = _heads_of(got, dev)
    dets = [rp._detections(exp.model, rp._fuse(exp.model, heads, b, hw, fusion_dtype,
                                               emit_marginals=True, defer_maps=True))
            for b in range(heads.cls_probs.shape[0])]
    return torch.stack([d.valid for d in dets]), torch.stack([d.roi_boxes for d in dets])


def embeds_gap(got: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor) -> float | None:
    """Relative L2 gap of the embeddings of the valid detections; None
    when there are none (the invalid rows are zeros on both sides)."""
    mask = valid.cpu()
    return rel(got.float().cpu()[mask], ref.float().cpu()[mask]) if mask.any() else None


@torch.no_grad()
def follow(exp, got: dict, state_in: dict, frame_id: int, hw, dev, fusion_dtype):
    """Stage B of one kept step over its streams: the reference's fusion,
    detections, tracker and render from the program's outputs and state.
    Returns (maps {name: (B, H, W)}, states [TrackerState], detections)."""
    cfg = exp.model
    heads = _heads_of(got, dev)
    maps, states, dets = {k: [] for k in ("semantic", "panoptic", "track_map", "depth")}, [], []
    for b in range(heads.cls_probs.shape[0]):
        pano = rp._fuse(cfg, heads, b, hw, fusion_dtype, emit_marginals=True, defer_maps=True)
        det = rp._detections(cfg, pano)
        out, st = rp._track_and_render(cfg, pano, det, got["embeds"][b].to(dev).float(),
                                       _state(state_in, b, dev),
                                       torch.full((), frame_id, dtype=torch.int32, device=dev))
        for k in maps:
            maps[k].append(getattr(out, k))
        states.append(st)
        dets.append(det)
    return {k: torch.stack(v) for k, v in maps.items()}, states, dets


def compare(exp, cell, sd, frames, kept: dict, keep: list, dev, dtypes):
    """The checks of a serving run: ([(name, value, limit)] of the numbers
    the cell's limits file names, failed frames, notes)."""
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    missing = [t for t in keep if t not in kept]
    streams = frames.shape[1]
    cycle = frames.shape[0]
    model = reference_network(exp, sd, dev, dtypes["compute_dtype"])
    worst = {k: 0.0 for k in ("rpn_rel_err", "stages_rel_err", "embeds_rel_err",
                              "maps_mismatch", "depth_rel_err", "state_err")}
    failed, notes = 0, []
    segs, detn, per = [], [], []
    for t in sorted(kept):
        k = kept[t]
        fpn, ref_heads = network_outputs(model, frames[t % cycle], dtypes["compute_dtype"])
        gaps = network_gaps(model, k["heads"], ref_heads, dev)
        per.append({n: float(f"{v:.3g}") for n, v in gaps.items()})
        step = {n: gaps[n] for n in ("rpn_rel_err", "stages_rel_err")}
        maps, states, dets = follow(exp, k["heads"], k["state_in"], t,
                                    tuple(frames.shape[2:4]), dev, dtypes["fusion_dtype"])
        valid = torch.stack([d.valid for d in dets])
        boxes = torch.stack([d.roi_boxes for d in dets])
        ref_emb = model.forward_track_embeds(fpn, None, valid, boxes=boxes)
        step["embeds_rel_err"] = embeds_gap(k["heads"]["embeds"], ref_emb, valid) or 0.0
        px = [(k["maps"][n] != maps[n].cpu()).double().mean().item()
              for n in ("semantic", "panoptic", "track_map")]
        step["maps_mismatch"] = max(px)
        ref_depth = maps["depth"].cpu()
        step["depth_rel_err"] = ((k["maps"]["depth"] - ref_depth).abs().max().item()
                                 / max(ref_depth.abs().max().item(), 1e-30))
        prog_states = [_state(k["state_out"], b, dev) for b in range(streams)]
        step["state_err"] = max(state_gap(p, r) for p, r in zip(prog_states, states))
        if any(step[n] > limits[n] for n in step if n in limits):
            failed += streams
        for n, v in step.items():
            worst[n] = max(worst[n], v)
        segs.append(sum(int(p.amax().item()) for p in maps["panoptic"]) / streams)
        detn.append(valid.sum().item() / streams)
        del fpn, ref_heads, maps, states, dets
    failed += streams * len(missing)
    if missing:
        notes.append(f"check: kept steps never served: {missing}")
    notes.append(f"check: steps {sorted(kept)}; kept segments a frame {segs}; "
                 f"detections a frame {detn}; network gaps {per}")
    notes.append("check: not compared " + ", ".join(
        f"{n}={v!r}" for n, v in worst.items() if n not in limits))
    checks = [(n, (None if missing else worst[n]), limits[n]) for n in limits]
    return checks, failed, notes
