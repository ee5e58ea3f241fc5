"""Weight bridge between the JAX package's variables and the port's
``state_dict``, through the reference checkpoint key mapping of
``polyphonicformer_tpu/tools/convert_torch_ckpt.py``.

JAX -> port: :func:`from_jax_variables` walks ``build_param_mapping`` and
applies ``_inverse_transform``.  Port -> JAX: ``convert_state_dict`` as it
stands, on ``{k: v.numpy()}`` of the port's ``state_dict()``.  The
``linear_chw2hwc_7`` entry (``track_head.fcs.0``) maps onto the C-major
flatten of the port's NCHW RoI features.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from polyphonicformer_tpu.tools.convert_torch_ckpt import (
    _inverse_transform,
    build_param_mapping,
    flatten_tree,
)


def from_jax_variables(variables_np, cfg) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested dicts of arrays -> a
    state_dict with the reference torch keys (f32 CPU tensors)."""
    params = flatten_tree(variables_np["params"])
    stats = flatten_tree(variables_np.get("batch_stats", {}))
    mapping = build_param_mapping(cfg.num_stages, cfg.backbone, cfg.with_track,
                                  cfg.num_cls_fcs, cfg.num_mask_fcs)
    sd = {}
    for path, (key, kind) in mapping.items():
        if path.startswith("BATCHSTATS::"):
            arr = stats[path[len("BATCHSTATS::"):]]
        else:
            arr = params[path]
        sd[key] = torch.from_numpy(
            np.array(_inverse_transform(np.asarray(arr, np.float32), kind)))
    return sd


def to_numpy_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The port's state_dict as numpy arrays, the input of
    ``convert_state_dict``."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
