"""Convert a reference PyTorch checkpoint (``polyphonic_r50_{image,video}.pth``)
into the JAX CLIs' ``.pkl`` of variables, without JAX; the port's
counterpart of ``polyphonicformer_tpu/tools/convert_torch_ckpt.py``.

    python -m polyphonicformer_torch.tools.convert_torch_ckpt \\
        --ckpt polyphonic_r50_video.pth --out video.pkl --video
    python -m polyphonicformer_torch.tools.convert_torch_ckpt --self-test

The output is what the JAX tool writes: ``{'params': ..., 'batch_stats':
...}`` as nested dicts of numpy arrays, through the key mapping and layout
transforms of ``weights.py`` (the port's copy of the JAX tool's).  The
port's CLIs read it with ``weights.load_variables`` (``--checkpoint``,
``--load-from``), and so do the JAX CLIs.  A ``.pth`` loads with
``torch.load(weights_only=True)`` (mmcv's ``meta`` types ``OrderedDict`` and
``datetime`` allowed); a full unpickle runs code from the file and happens
only under ``--unsafe-load``.
"""
from __future__ import annotations

import argparse
import collections
import datetime
import pickle
from typing import Dict

import numpy as np
import torch

from ..configs import ModelConfig
from ..weights import (_inverse_transform, build_param_mapping, flatten_tree,
                       map_state_dict)


def convert_state_dict(state_dict: Dict[str, np.ndarray], model_cfg) -> Dict:
    """torch state_dict (numpy values) -> {'params': ..., 'batch_stats': ...};
    ``KeyError`` when a mapped key is missing, ``ValueError`` for a backbone
    the mapping does not know (STDC: no reference checkpoint holds one)."""
    mapping = build_param_mapping(model_cfg.num_stages, model_cfg.backbone,
                                  model_cfg.with_track)
    return map_state_dict(state_dict, mapping)


def self_test(backbone: str = "resnet50") -> None:
    """The mapping is a bijection onto the port model's ``state_dict`` keys
    (built on the meta device, with the track head), and a synthetic state
    dict of the model's shapes converts and maps back to itself."""
    from ..models import PolyphonicFormer
    from ..weights import from_jax_variables

    cfg = ModelConfig(backbone=backbone, out_channels=64, fpn_out_channels=64,
                      feedforward_channels=128, num_proposals=10, with_track=True)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    mapping = build_param_mapping(cfg.num_stages, cfg.backbone, cfg.with_track)
    keys = [key for key, _ in mapping.values()]
    assert len(set(keys)) == len(keys), "two parameters map onto one torch key"
    only_map, only_model = sorted(set(keys) - set(shapes)), sorted(set(shapes) - set(keys))
    assert not only_map, f"mapping has unknown torch keys: {only_map[:10]}"
    assert not only_model, f"unmapped model keys: {only_model[:10]}"

    rng = np.random.RandomState(0)
    sd = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    converted = convert_state_dict(sd, cfg)
    flat = flatten_tree(converted["params"])
    flat.update({f"BATCHSTATS::{k}": v
                 for k, v in flatten_tree(converted["batch_stats"]).items()})
    assert set(flat) == set(mapping)
    for path, (key, kind) in mapping.items():
        np.testing.assert_array_equal(_inverse_transform(flat[path], kind), sd[key])
    back = from_jax_variables(converted, cfg)
    with torch.device("meta"):
        model = PolyphonicFormer(cfg)
    result = model.load_state_dict(back, strict=True, assign=True)
    assert not result.missing_keys and not result.unexpected_keys
    print(f"self-test OK ({backbone}): {len(mapping)} parameters mapped bijectively")


def load_torch_state_dict(path: str, allow_unsafe: bool = False) -> Dict[str, np.ndarray]:
    """A ``torch.save`` checkpoint file -> numpy state dict.

    The published checkpoints wrap the weights as {'state_dict': ...,
    'meta': {...}} (mmcv's CheckpointHook).  The safe load admits tensors,
    builtin containers and the stdlib ``OrderedDict`` and ``datetime`` that
    mmcv's meta holds; a full unpickle (arbitrary code from the file: the
    published files are third-party downloads) happens only with
    ``allow_unsafe``."""
    try:
        with torch.serialization.safe_globals([collections.OrderedDict, datetime.datetime]):
            raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_unsafe:
            raise RuntimeError(
                f"{path}: weights_only=True load failed and full unpickle "
                "is disabled (it runs arbitrary code from the file). "
                "Re-run with --unsafe-load if you trust this checkpoint.")
        raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", help="path to reference .pth checkpoint")
    ap.add_argument("--out", help="output .pkl for the converted variables")
    ap.add_argument("--video", action="store_true", help="video model (track head)")
    ap.add_argument("--backbone", default="resnet50",
                    help="resnet50 | swin_tiny | swin_large")
    ap.add_argument("--self-test", action="store_true")
    ap.add_argument("--unsafe-load", action="store_true",
                    help="permit full-unpickle torch.load fallback "
                         "(arbitrary code execution on a tampered file)")
    args = ap.parse_args(argv)
    if args.self_test:
        self_test("resnet50")
        self_test("swin_tiny")
        return
    sd = load_torch_state_dict(args.ckpt, allow_unsafe=args.unsafe_load)
    cfg = ModelConfig(with_track=args.video, backbone=args.backbone)
    variables = convert_state_dict(sd, cfg)
    with open(args.out, "wb") as f:
        pickle.dump(variables, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
