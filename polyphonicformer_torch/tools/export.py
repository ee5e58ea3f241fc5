"""Serving export: the port's serving step traced by ``torch.export`` into
an artifact that loads and runs without the model-building code; the port
of ``polyphonicformer_tpu/tools/export.py``, with the same flags plus
``--device``.

Weights stay out of the artifact: the exported program takes the model's
f32 ``state_dict()`` as its first argument and casts it inside to the
compute dtype (as the JAX export takes its f32 variables), so one artifact
serves every checkpoint of the architecture.  The export is
shape-specialised and made on the device it serves on; the kernels stay in
its graph as ``poly::`` custom ops (K1, K2 and K4; K3 with ``--bf16``; K7
and K8 on Swin-L), so the loaded program launches them as the eager step
does.  Before saving, the program's example inputs are dropped: they would
put the state dict into the artifact, and their ``TrackerState`` could only
be unpickled by ``torch.export.load``'s fallback to ``weights_only=False``.
The artifact holds the graph and the small constant tables of
``ops/device_tables.py``, and no pickle.

Modes (as ``infer/pipeline.py``):
  image : fn(state_dict, image[1,H,W,3]) -> PanopticResult
  frame : fn(state_dict, image[1,H,W,3], tracker_state, frame_id)
          -> (FrameOutput, TrackerState)  streaming video serving
  clip  : fn(state_dict, images[T,H,W,3], tracker_state, first_frame_id)
          -> (ClipOutput, TrackerState)  the clip loop, unrolled T frames
``frame_id`` and ``first_frame_id`` are () int32 tensors on the device.

Usage:
  python -m polyphonicformer_torch.tools.export --mode clip --hw 1024 2048 \\
      --clip-len 8 --bf16 --checkpoint vars.pkl --out serving_clip.pt2 [--device cpu]
Load side (no configuration, no model):
  from polyphonicformer_torch.tools.export import load_serving
  fn = load_serving("serving_clip.pt2")
  outs, state = fn(state_dict, images, state, frame_id)
"""
from __future__ import annotations

import argparse
import io
from typing import Optional, Tuple

import torch

_SERIAL_PREFIX = "polyphonicformer_torch."


def register_export_types() -> None:
    """Give the output containers and ``TrackerState`` stable serialized
    names; both the export and the load side call this.  Idempotent."""
    from torch.utils import _pytree

    from ..infer.panoptic import PanopticResult
    from ..infer.pipeline import ClipOutput, FrameOutput
    from ..infer.tracker import TrackerState

    for nt in (PanopticResult, FrameOutput, ClipOutput):
        if nt not in _pytree.SUPPORTED_SERIALIZED_TYPES:
            _pytree._register_namedtuple(nt, serialized_type_name=_SERIAL_PREFIX + nt.__name__)
    if TrackerState not in _pytree.SUPPORTED_NODES:
        torch.export.register_dataclass(TrackerState,
                                        serialized_type_name=_SERIAL_PREFIX + "TrackerState")


class _WeightFree(torch.nn.Module):
    """``forward(state_dict, *args)``: ``mode``'s serving step of ``model``
    with its weights and buffers taken from ``state_dict``, the floating
    ones cast to ``compute_dtype``.  The model is held outside the module
    tree, so none of its own tensors enters the export."""

    def __init__(self, model, cfg, mode: str, out_hw: Tuple[int, int],
                 compute_dtype: torch.dtype, fusion_dtype: torch.dtype):
        super().__init__()
        from ..infer import pipeline

        steps = {"image": pipeline.image_step, "frame": pipeline.video_frame_step,
                 "clip": pipeline.clip_video_step}
        if mode not in steps:
            raise ValueError(f"unknown export mode: {mode}")
        self.__dict__["model"] = model
        self.cfg, self.step, self.out_hw = cfg, steps[mode], tuple(out_hw)
        self.compute_dtype, self.fusion_dtype = compute_dtype, fusion_dtype

    def forward(self, state_dict, *args):
        from torch.nn.utils.stateless import _reparametrize_module

        cast = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in state_dict.items()}
        with _reparametrize_module(self.model, cast, strict=True):
            return self.step(self.model, self.cfg, *args, out_hw=self.out_hw,
                             compute_dtype=self.compute_dtype, fusion_dtype=self.fusion_dtype)


def build_serving_fn(model, cfg, mode: str, out_hw: Tuple[int, int], bf16: bool = False):
    """The weight-free serving callable for ``mode`` (image|frame|clip):
    ``fn(state_dict, *args)`` as the module docstring lists; ``bf16``: the
    network and the fusion in bf16."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    return _WeightFree(model, cfg, mode, out_hw, dtype, dtype)


def example_args(model, cfg, mode: str, out_hw: Tuple[int, int], clip_len: int = 8) -> tuple:
    """Arguments of the right shapes on the model's device: its state dict,
    zero images, a fresh tracker state and frame id 1."""
    from ..infer.tracker import init_tracker_state

    dev = next(model.parameters()).device
    h, w = out_hw
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    images = torch.zeros((clip_len if mode == "clip" else 1, h, w, 3), device=dev)
    if mode == "image":
        return sd, images
    state = init_tracker_state(cfg.tracker, cfg.track_head.embed_channels, dev)
    return sd, images, state, torch.ones((), dtype=torch.int32, device=dev)


def export_program(model, cfg, mode: str, out_hw: Tuple[int, int], clip_len: int = 8,
                   bf16: bool = False) -> torch.export.ExportedProgram:
    """Trace the serving step of ``model`` (f32, in eval mode, on the device
    it will serve on); the program's example inputs are dropped."""
    if next(model.parameters()).dtype != torch.float32:
        raise ValueError("export takes the f32 model; --bf16 casts inside the program")
    register_export_types()
    fn = build_serving_fn(model, cfg, mode, out_hw, bf16=bf16)
    with torch.no_grad():
        ep = torch.export.export(fn, example_args(model, cfg, mode, out_hw, clip_len),
                                 strict=False)
    ep.example_inputs = None
    return ep


def export_serving(model, cfg, mode: str, out_hw: Tuple[int, int], clip_len: int = 8,
                   bf16: bool = False) -> bytes:
    """The serialized artifact of :func:`export_program`."""
    buf = io.BytesIO()
    torch.export.save(export_program(model, cfg, mode, out_hw, clip_len, bf16), buf)
    return buf.getvalue()


def poly_ops(program: torch.export.ExportedProgram) -> dict:
    """{op name: count} of the ``poly::`` custom-op nodes in the graph."""
    counts: dict = {}
    for node in program.graph.nodes:
        target = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and target.startswith("poly::"):
            name = target.split("::")[1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _register_ops() -> None:
    """Define the ``poly::`` ops the graph calls (importing their modules
    builds no kernel)."""
    from ..ops.cuda import (lsa, map_render, mask_loss, mask_pool, phase_fusion,  # noqa: F401
                            upsample2, window_attn)


class Serving:
    """A loaded artifact: ``fn(state_dict, *args)``.  The state dict's keys
    are put in the exported order."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()
        spec = program.call_spec.in_spec  # ((state_dict, *args), kwargs)
        child = spec.child if hasattr(spec, "child") else lambda i: spec.children_specs[i]
        args = child(0)
        sd_spec = args.child(0) if hasattr(args, "child") else args.children_specs[0]
        self._keys = sd_spec.context

    def __call__(self, state_dict, *args):
        sd = {k: state_dict[k] for k in self._keys}
        with torch.no_grad():
            return self._module(sd, *args)


def load_serving(path_or_bytes) -> Serving:
    """Deserialize an exported serving artifact into a callable; it needs
    the ``poly::`` ops and the output types, not the model code or its
    configuration."""
    register_export_types()
    _register_ops()
    blob = path_or_bytes
    if isinstance(blob, (bytes, bytearray)):
        blob = io.BytesIO(blob)
    return Serving(torch.export.load(blob))


def main(argv: Optional[list] = None) -> dict:
    """Returns mode, hw, bf16, bytes, export seconds and the graph's poly ops."""
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["image", "frame", "clip"], default="clip")
    ap.add_argument("--hw", type=int, nargs=2, default=[1024, 2048])
    ap.add_argument("--clip-len", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 network and fusion (the K3 fusion kernel)")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="converted .pkl variables (optional: the artifact is weight-free "
                         "either way; a checkpoint only checks the shapes against it)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to export for (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    from ..models import build_model
    from ._cli import experiment, load_model, select_device

    dev = select_device(args.device)
    cfg = experiment(args.preset, with_track=args.mode != "image").model
    if args.checkpoint:
        model = load_model(args.checkpoint, cfg, dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = build_model(cfg, dev, generator=gen)
    t0 = time.perf_counter()
    program = export_program(model, cfg, args.mode, tuple(args.hw), clip_len=args.clip_len,
                             bf16=args.bf16)
    seconds = time.perf_counter() - t0
    torch.export.save(program, args.out)
    with open(args.out, "rb") as f:
        size = len(f.read())
    info = {"mode": args.mode, "hw": list(args.hw), "bf16": args.bf16, "bytes": size,
            "export_s": seconds, "poly_ops": poly_ops(program)}
    print(f"wrote {args.out}: mode={args.mode} hw={tuple(args.hw)} bf16={args.bf16} "
          f"bytes={size} export_s={seconds:.2f} poly_ops={info['poly_ops']}")
    return info


if __name__ == "__main__":
    main()
