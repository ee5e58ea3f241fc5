"""Weight bridge between the JAX package's variables and the port's
``state_dict``, through the reference checkpoint's key mapping.

The port's own copy of ``polyphonicformer_tpu/tools/convert_torch_ckpt.py``'s
mapping (``build_param_mapping`` and its helpers, the layout transforms
and the tree flattening), so the port imports nothing of the JAX package;
``tests/test_torch_weights.py`` pins the copy to the original.  The STDC
backbones and the ASPP head, which no reference checkpoint holds, map
through :func:`_stdc_mapping` and :func:`_aspp_mapping` onto port keys
named after the JAX flax paths (:func:`_mapping`).  The port's checkpoint
converter is ``tools/convert_torch_ckpt.py``.  Every flax parameter path
('a/b/c', with a ``BATCHSTATS::`` prefix for the statistics collection) maps
onto one key of the reference model's state dict and a layout transform:

  conv weight   (O, I, kh, kw) -> (kh, kw, I, O)
  linear weight (O, I)         -> (I, O)
  1x1 query convs (N, C, 1, 1) -> (N, C)
  track_head.fcs.0 (O, C*7*7) C-major -> (7*7*C, O) HWC-major
  Swin patch merging (O, C*2*2) C-major -> (2*2*C, O) HWC-major, and its
  LayerNorm's (C*2*2,) vectors likewise

JAX -> port: :func:`from_jax_variables`.  Port -> JAX:
:func:`to_jax_variables` on :func:`to_numpy_state_dict` (also used on a
dict of gradients, which share the parameters' keys).  The JAX CLIs'
checkpoints (a ``.pkl`` of those variables as numpy arrays) load with
:func:`load_variables`.
"""
from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from .configs import STDC_LAYERS, SWIN_SPECS

_STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3)}
_SWIN_DEPTHS = {name: spec[1] for name, spec in SWIN_SPECS.items()}

Mapping = Dict[str, Tuple[str, str]]


def _convnormact(torch_prefix: str, has_gn: bool = True) -> Mapping:
    out = {"conv/kernel": (f"{torch_prefix}.conv.weight", "conv")}
    if has_gn:
        out["gn/scale"] = (f"{torch_prefix}.gn.weight", "copy")
        out["gn/bias"] = (f"{torch_prefix}.gn.bias", "copy")
    else:
        out["conv/bias"] = (f"{torch_prefix}.conv.bias", "copy")
    return out


def _prefix(entries: Mapping, flax_prefix: str) -> Mapping:
    return {f"{flax_prefix}/{k}": v for k, v in entries.items()}


def _linear(flax_path: str, torch_prefix: str, bias: bool = True) -> Mapping:
    out = {f"{flax_path}/kernel": (f"{torch_prefix}.weight", "linear")}
    if bias:
        out[f"{flax_path}/bias"] = (f"{torch_prefix}.bias", "copy")
    return out


def _ln(flax_path: str, torch_prefix: str) -> Mapping:
    return {f"{flax_path}/scale": (f"{torch_prefix}.weight", "copy"),
            f"{flax_path}/bias": (f"{torch_prefix}.bias", "copy")}


def _frozen_bn(flax_path: str, torch_prefix: str) -> Mapping:
    return {
        f"{flax_path}/scale": (f"{torch_prefix}.weight", "copy"),
        f"{flax_path}/bias": (f"{torch_prefix}.bias", "copy"),
        f"BATCHSTATS::{flax_path}/mean": (f"{torch_prefix}.running_mean", "copy"),
        f"BATCHSTATS::{flax_path}/var": (f"{torch_prefix}.running_var", "copy"),
    }


def _swin_mapping(depths) -> Mapping:
    """The Swin backbone in the mmdet state-dict layout: patch_embed,
    stages.{s}.blocks.{b}.{norm1, attn.w_msa, norm2, ffn}, stages.{s}
    .downsample and the output norms norm{s}.  The bias table copies as it
    is; patch merging's reduction weight and pre-norm vectors are reordered
    from the reference's channel-major 2x2 gather to JAX's (y, x, C)."""
    m: Mapping = {}
    m["backbone/patch_embed/kernel"] = ("backbone.patch_embed.projection.weight", "conv")
    m["backbone/patch_embed/bias"] = ("backbone.patch_embed.projection.bias", "copy")
    m.update(_ln("backbone/patch_norm", "backbone.patch_embed.norm"))
    for s, depth_s in enumerate(depths):
        for b in range(depth_s):
            fp = f"backbone/stage{s}_block{b}"
            tp = f"backbone.stages.{s}.blocks.{b}"
            m.update(_ln(f"{fp}/norm1", f"{tp}.norm1"))
            m.update(_linear(f"{fp}/attn/qkv", f"{tp}.attn.w_msa.qkv"))
            m.update(_linear(f"{fp}/attn/proj", f"{tp}.attn.w_msa.proj"))
            m[f"{fp}/attn/relative_position_bias_table"] = (
                f"{tp}.attn.w_msa.relative_position_bias_table", "copy")
            m.update(_ln(f"{fp}/norm2", f"{tp}.norm2"))
            m.update(_linear(f"{fp}/mlp_fc1", f"{tp}.ffn.layers.0.0"))
            m.update(_linear(f"{fp}/mlp_fc2", f"{tp}.ffn.layers.1"))
        if s < len(depths) - 1:
            dp = f"backbone.stages.{s}.downsample"
            m[f"backbone/merge{s}/norm/scale"] = (f"{dp}.norm.weight", "vec_chw2hwc_2")
            m[f"backbone/merge{s}/norm/bias"] = (f"{dp}.norm.bias", "vec_chw2hwc_2")
            m[f"backbone/merge{s}/reduction/kernel"] = (f"{dp}.reduction.weight",
                                                        "linear_chw2hwc_2")
        m.update(_ln(f"backbone/out_norm{s}", f"backbone.norm{s}"))
    return m


def _backbone_mapping(depth: str) -> Mapping:
    if depth in _SWIN_DEPTHS:
        return _swin_mapping(_SWIN_DEPTHS[depth])
    if depth not in _STAGE_BLOCKS:
        raise ValueError(
            f"unknown backbone {depth!r}; converter supports "
            f"{sorted(_STAGE_BLOCKS) + sorted(_SWIN_DEPTHS)}")
    m: Mapping = {}
    m["backbone/conv1/kernel"] = ("backbone.conv1.weight", "conv")
    m.update(_frozen_bn("backbone/bn1", "backbone.bn1"))
    for s, blocks in enumerate(_STAGE_BLOCKS[depth]):
        for b in range(blocks):
            fp = f"backbone/layer{s + 1}_{b}"
            tp = f"backbone.layer{s + 1}.{b}"
            for c in (1, 2, 3):
                m[f"{fp}/conv{c}/kernel"] = (f"{tp}.conv{c}.weight", "conv")
                m.update(_frozen_bn(f"{fp}/bn{c}", f"{tp}.bn{c}"))
            if b == 0:
                m[f"{fp}/downsample_conv/kernel"] = (f"{tp}.downsample.0.weight", "conv")
                m.update(_frozen_bn(f"{fp}/downsample_bn", f"{tp}.downsample.1"))
    return m


def build_param_mapping(num_stages: int = 3, depth: str = "resnet50",
                        with_track: bool = False, num_cls_fcs: int = 1,
                        num_mask_fcs: int = 1) -> Mapping:
    """flax path -> (torch state_dict key, transform), ResNet-50 and Swin
    backbones: the reference checkpoints' layout, as the JAX tool maps it
    (which knows no STDC backbone and no ASPP head: see :func:`_mapping`)."""
    m = _backbone_mapping(depth)
    m.update(_head_mapping(num_stages, with_track, num_cls_fcs, num_mask_fcs))
    return m


def _head_mapping(num_stages: int, with_track: bool, num_cls_fcs: int,
                  num_mask_fcs: int) -> Mapping:
    m: Mapping = {}
    for i in range(4):
        m[f"neck/lateral_{i}/kernel"] = (f"neck.lateral_convs.{i}.conv.weight", "conv")
        m[f"neck/lateral_{i}/bias"] = (f"neck.lateral_convs.{i}.conv.bias", "copy")
        m[f"neck/fpn_{i}/kernel"] = (f"neck.fpn_convs.{i}.conv.weight", "conv")
        m[f"neck/fpn_{i}/bias"] = (f"neck.fpn_convs.{i}.conv.bias", "copy")

    sf, tsf = "rpn_head/localization_fpn", "rpn_head.localization_fpn"
    for lvl, convs in {0: [0], 1: [0], 2: [0, 1], 3: [0, 1, 2]}.items():
        for j in convs:
            m.update(_prefix(_convnormact(f"{tsf}.convs_all_levels.{lvl}.conv{j}"),
                             f"{sf}/lvl{lvl}_conv{j}"))
    m.update(_prefix(_convnormact(f"{tsf}.conv_pred"), f"{sf}/conv_pred"))
    for i in range(2):
        m.update(_prefix(_convnormact(f"{tsf}.aux_convs.{i}"), f"{sf}/aux_conv{i}"))
    for name in ("loc", "seg", "depth"):
        m.update(_prefix(_convnormact(f"rpn_head.{name}_convs.0"), f"rpn_head/{name}_conv0"))
    m["rpn_head/init_kernels"] = ("rpn_head.init_kernels.weight", "squeeze11")
    m["rpn_head/conv_seg_weight"] = ("rpn_head.conv_seg.weight", "squeeze11")
    m["rpn_head/conv_seg_bias"] = ("rpn_head.conv_seg.bias", "copy")
    m["rpn_head/conv_direct_depth_weight"] = ("rpn_head.conv_direct_depth.weight", "squeeze11")
    m["rpn_head/conv_direct_depth_bias"] = ("rpn_head.conv_direct_depth.bias", "copy")

    for s in range(num_stages):
        fp, tp = f"mask_head_{s}", f"roi_head.mask_head.{s}"
        for t in ("feat_transform", "feat_depth_transform"):
            m[f"{fp}/{t}/kernel"] = (f"{tp}.{t}.conv.weight", "conv")
            m[f"{fp}/{t}/bias"] = (f"{tp}.{t}.conv.bias", "copy")
        for ku in ("kernel_update_conv", "kernel_update_conv_depth"):
            for lin in ("dynamic_layer", "input_layer", "input_gate", "update_gate",
                        "fc_layer"):
                m.update(_linear(f"{fp}/{ku}/{lin}", f"{tp}.{ku}.{lin}"))
            for ln in ("norm_in", "norm_out", "input_norm_in", "input_norm_out", "fc_norm"):
                m.update(_ln(f"{fp}/{ku}/{ln}", f"{tp}.{ku}.{ln}"))
        for att in ("attention", "attention_depth"):
            m[f"{fp}/{att}/in_proj_weight"] = (f"{tp}.{att}.attn.in_proj_weight", "copy")
            m[f"{fp}/{att}/in_proj_bias"] = (f"{tp}.{att}.attn.in_proj_bias", "copy")
            m[f"{fp}/{att}/out_proj_weight"] = (f"{tp}.{att}.attn.out_proj.weight", "copy")
            m[f"{fp}/{att}/out_proj_bias"] = (f"{tp}.{att}.attn.out_proj.bias", "copy")
        m.update(_ln(f"{fp}/attention_norm", f"{tp}.attention_norm"))
        m.update(_ln(f"{fp}/attention_norm_depth", f"{tp}.attention_norm_depth"))
        for ffn in ("ffn", "ffn_depth"):
            m.update(_linear(f"{fp}/{ffn}/fc1", f"{tp}.{ffn}.layers.0.0"))
            m.update(_linear(f"{fp}/{ffn}/fc2", f"{tp}.{ffn}.layers.1"))
        m.update(_ln(f"{fp}/ffn_norm", f"{tp}.ffn_norm"))
        m.update(_ln(f"{fp}/ffn_norm_depth", f"{tp}.ffn_norm_depth"))
        # the reference interleaves [Linear, LN, ReLU] (depth: [Linear, LN])
        for i in range(num_cls_fcs):
            m.update(_linear(f"{fp}/cls_fc{i}", f"{tp}.cls_fcs.{3 * i}", bias=False))
            m.update(_ln(f"{fp}/cls_ln{i}", f"{tp}.cls_fcs.{3 * i + 1}"))
        for i in range(num_mask_fcs):
            m.update(_linear(f"{fp}/mask_fc{i}", f"{tp}.mask_fcs.{3 * i}", bias=False))
            m.update(_ln(f"{fp}/mask_ln{i}", f"{tp}.mask_fcs.{3 * i + 1}"))
            m.update(_linear(f"{fp}/depth_fc{i}", f"{tp}.depth_regs.{2 * i}", bias=False))
            m.update(_ln(f"{fp}/depth_ln{i}", f"{tp}.depth_regs.{2 * i + 1}"))
        for lin in ("fc_cls", "fc_mask", "fc_depth"):
            m.update(_linear(f"{fp}/{lin}", f"{tp}.{lin}"))

    if with_track:
        for i in range(4):
            m.update(_prefix(_convnormact(f"track_head.convs.{i}"),
                             f"track_head/embed_mlp/conv{i}"))
        m["track_head/embed_mlp/fc0/kernel"] = ("track_head.fcs.0.weight", "linear_chw2hwc_7")
        m["track_head/embed_mlp/fc0/bias"] = ("track_head.fcs.0.bias", "copy")
        m.update(_linear("track_head/embed_mlp/fc_embed", "track_head.fc_embed"))
    return m


def _transform(arr: np.ndarray, kind: str) -> np.ndarray:
    """torch layout -> JAX layout."""
    if kind == "copy":
        return arr
    if kind == "conv":
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == "linear":
        return np.transpose(arr, (1, 0))
    if kind == "squeeze11":
        return arr[:, :, 0, 0]
    if kind.startswith("linear_chw2hwc_"):
        k = int(kind.rsplit("_", 1)[1])
        o, ckk = arr.shape
        c = ckk // (k * k)
        return np.transpose(arr.reshape(o, c, k, k).transpose(0, 2, 3, 1).reshape(o, -1), (1, 0))
    if kind.startswith("vec_chw2hwc_"):
        k = int(kind.rsplit("_", 1)[1])
        c = arr.shape[0] // (k * k)
        return arr.reshape(c, k, k).transpose(1, 2, 0).reshape(-1)
    raise ValueError(kind)


def _inverse_transform(arr: np.ndarray, kind: str) -> np.ndarray:
    """JAX layout -> torch layout."""
    if kind == "copy":
        return arr
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "linear":
        return np.transpose(arr, (1, 0))
    if kind == "squeeze11":
        return arr[:, :, None, None]
    if kind.startswith("linear_chw2hwc_"):
        k = int(kind.rsplit("_", 1)[1])
        kkc, o = arr.shape
        c = kkc // (k * k)
        w = np.transpose(arr, (1, 0)).reshape(o, k, k, c)
        return w.transpose(0, 3, 1, 2).reshape(o, -1)
    if kind.startswith("vec_chw2hwc_"):
        k = int(kind.rsplit("_", 1)[1])
        c = arr.shape[0] // (k * k)
        return arr.reshape(k, k, c).transpose(2, 0, 1).reshape(-1)
    raise ValueError(kind)


def flatten_tree(tree, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Dict) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _convx(flax_path: str, torch_prefix: str) -> Mapping:
    """An STDC ConvX: conv and frozen BN."""
    return {f"{flax_path}/conv/kernel": (f"{torch_prefix}.conv.weight", "conv"),
            **_frozen_bn(f"{flax_path}/bn", f"{torch_prefix}.bn")}


def _stdc_mapping(layers) -> Mapping:
    """The STDC backbone of ``models/stdc.py`` (Cat bottlenecks of 4
    ConvX, as ``PolyphonicFormer`` builds it).  No
    reference checkpoint holds one, so the torch keys are the port's own,
    named after the JAX flax paths; its BN statistics take the
    ``BATCHSTATS::`` route, as ResNet's."""
    m: Mapping = {}
    for stem in ("stem0", "stem1"):
        m.update(_convx(f"backbone/{stem}", f"backbone.{stem}"))
    for i, num in enumerate(layers):
        for j in range(num):
            fp, tp = f"backbone/stage{i}_{j}", f"backbone.stage{i}_{j}"
            for c in range(4):
                m.update(_convx(f"{fp}/conv{c}", f"{tp}.conv{c}"))
            if j == 0:  # the stride-2 block's depthwise "avd" conv
                m[f"{fp}/avd_conv/kernel"] = (f"{tp}.avd_conv.weight", "conv")
                m.update(_frozen_bn(f"{fp}/avd_bn", f"{tp}.avd_bn"))
    return m


def _aspp_mapping(dilations) -> Mapping:
    """The ASPP auxiliary semantic head (``models/aspp.py``) and its 1x1
    predictor: port keys named after the JAX flax paths, as for STDC."""
    fp, tp = "rpn_head/semantic_aspp", "rpn_head.semantic_aspp"
    m: Mapping = {}
    names = [f"branch{i}" for i in range(len(dilations))] + ["image_pool", "project"]
    for name in names:
        m[f"{fp}/{name}_conv/kernel"] = (f"{tp}.{name}_conv.weight", "conv")
        m.update(_ln(f"{fp}/{name}_gn", f"{tp}.{name}_gn"))
    m["rpn_head/semantic_aspp_predict_weight"] = ("rpn_head.semantic_aspp_predict.weight",
                                                  "squeeze11")
    m["rpn_head/semantic_aspp_predict_bias"] = ("rpn_head.semantic_aspp_predict.bias", "copy")
    return m


def _mapping(cfg) -> Mapping:
    """The whole model's mapping: :func:`build_param_mapping`, with the STDC
    backbone in place of ResNet's or Swin's, and the ASPP head where the
    configuration has them."""
    m = (_stdc_mapping(STDC_LAYERS[cfg.backbone]) if cfg.backbone in STDC_LAYERS
         else _backbone_mapping(cfg.backbone))
    m.update(_head_mapping(cfg.num_stages, cfg.with_track, cfg.num_cls_fcs, cfg.num_mask_fcs))
    if cfg.with_semantic_aspp:
        m.update(_aspp_mapping(cfg.aspp_dilations))
    return m


def from_jax_variables(variables_np, cfg) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested dicts of arrays -> a
    state_dict with the reference torch keys (f32 CPU tensors)."""
    params = flatten_tree(variables_np["params"])
    stats = flatten_tree(variables_np.get("batch_stats", {}))
    sd = {}
    for path, (key, kind) in _mapping(cfg).items():
        if path.startswith("BATCHSTATS::"):
            arr = stats[path[len("BATCHSTATS::"):]]
        else:
            arr = params[path]
        sd[key] = torch.from_numpy(
            np.array(_inverse_transform(np.asarray(arr, np.float32), kind)))
    return sd


def map_state_dict(state_dict_np: Dict[str, np.ndarray], mapping: Mapping,
                   partial: bool = False) -> Dict:
    """A state dict of numpy arrays -> {'params': ..., 'batch_stats': ...}
    in the JAX layout through ``mapping``.  ``partial`` skips the keys the
    dict lacks instead of raising ``KeyError``."""
    params, stats, missing = {}, {}, []
    for path, (key, kind) in mapping.items():
        if key not in state_dict_np:
            missing.append(key)
            continue
        arr = _transform(np.asarray(state_dict_np[key]), kind)
        if path.startswith("BATCHSTATS::"):
            stats[path[len("BATCHSTATS::"):]] = arr
        else:
            params[path] = arr
    if missing and not partial:
        raise KeyError(f"{len(missing)} torch keys missing, e.g. {missing[:5]}")
    return {"params": unflatten_tree(params), "batch_stats": unflatten_tree(stats)}


def to_jax_variables(state_dict_np: Dict[str, np.ndarray], cfg,
                     partial: bool = False) -> Dict:
    """A state dict of numpy arrays -> {'params': ..., 'batch_stats': ...}
    in the JAX layout (what ``convert_state_dict`` computes).  ``partial``
    skips the keys the dict lacks (a dict of gradients has no frozen or
    statistics entries) instead of raising."""
    return map_state_dict(state_dict_np, _mapping(cfg), partial)


def to_numpy_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A copy of the port's state_dict as f32 numpy arrays, the input of
    :func:`to_jax_variables`."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in model.state_dict().items()}


# what a pickle of nested dicts of numpy arrays names, across numpy 1 and 2
# and pickle protocols 2-5
_PICKLE_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
    ("_codecs", "encode"), ("collections", "OrderedDict"),
}
_PICKLE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
                    "bool", "str", "bytes", "bytearray"}


class _NumpyUnpickler(pickle.Unpickler):
    """Admits numpy arrays, numpy scalars and builtin containers only."""

    def find_class(self, module, name):
        if (module, name) in _PICKLE_GLOBALS or (module == "builtins"
                                                 and name in _PICKLE_BUILTINS):
            return super().find_class(module, name)
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise pickle.UnpicklingError(
                f"the checkpoint holds a {module}.{name} object: pickle the variables as "
                "numpy arrays (jax.tree_util.tree_map(np.asarray, variables)), as the JAX "
                "package's checkpoint converter writes them")
        raise pickle.UnpicklingError(
            f"the checkpoint names {module}.{name}: only numpy arrays and builtin "
            "containers are loaded")


def load_variables(path) -> Dict:
    """The JAX CLIs' ``--checkpoint``: a pickle of ``{'params': ...,
    'batch_stats': ...}`` as numpy arrays, read without running any other
    pickled code."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()
