"""Configuration of the port's serving and training paths (image and
2-frame video, Cityscapes-DVPS and SemKITTI-DVPS).

The fields of ``polyphonicformer_tpu/configs/config.py`` that the port
reads, under the same names and with the same defaults (the reference's
``configs/_base_/models/polyphonic_former.py``,
``configs/_base_/schedules/schedule_{1x,2x}.py`` and the leaf configs named
at each preset), so the port and everything it runs on import nothing of
the JAX package (the parallel mesh excepted: the port trains on one card).
``tests/test_torch_configs.py`` holds each preset field for field against
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DepthLossConfig:
    loss_weight: float = 5.0
    depth_act_mode: str = "sigmoid"  # 'sigmoid' | 'monodepth'
    si_weight: float = 1.0
    sq_rel_weight: float = 1.0
    abs_rel_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    cls_weight: float = 2.0
    dice_weight: float = 4.0
    mask_weight: float = 1.0
    depth_weight: float = 0.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    topk: int = 1  # >1: each GT takes its best `topk` prediction rows


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    init_score_thr: float = 0.35
    obj_score_thr: float = 0.3
    match_score_thr: float = 0.5
    memo_tracklet_frames: int = 5
    memo_backdrop_frames: int = 1
    memo_momentum: float = 0.8
    nms_conf_thr: float = 0.5
    nms_backdrop_iou_thr: float = 0.3
    nms_class_iou_thr: float = 0.7
    with_cats: bool = True
    match_metric: str = "bisoftmax"  # 'bisoftmax' | 'softmax' | 'cosine'
    # fixed capacities of the tracker state
    max_tracklets: int = 128
    max_detections: int = 64


@dataclasses.dataclass(frozen=True)
class TrackHeadConfig:
    num_convs: int = 4
    num_fcs: int = 1
    roi_feat_size: int = 7
    conv_out_channels: int = 256
    fc_out_channels: int = 1024
    embed_channels: int = 256
    gn_groups: int = 32
    # the track losses (train/video_losses.py, losses/track.py)
    loss_track_weight: float = 0.25
    loss_aux_weight: float = 1.0
    aux_neg_pos_ub: int = 3
    aux_pos_margin: float = 0.0
    aux_neg_margin: float = 0.1
    aux_hard_mining: bool = True
    softmax_temp: float = -1.0
    roi_sampling_ratio: int = 2
    featmap_strides: Tuple[int, ...] = (4, 8, 16, 32)
    finest_scale: int = 56
    # RoIAlign form: "gather" (the flattened-pyramid gather) or "separable"
    # (per-level interpolation matmuls; equal to float tolerance)
    roi_impl: str = "gather"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_thing_classes: int = 8
    num_stuff_classes: int = 11
    num_proposals: int = 100
    num_stages: int = 3
    mask_assign_stride: int = 4
    ignore_label: int = 255
    backbone: str = "resnet50"
    frozen_stages: int = 1
    fpn_out_channels: int = 256
    out_channels: int = 256
    num_heads: int = 8
    feedforward_channels: int = 2048
    sem_fpn_gn_groups: int = 32
    hard_mask_thr: float = 0.5
    num_cls_fcs: int = 1
    num_mask_fcs: int = 1
    depth_act_mode: str = "sigmoid"  # 'sigmoid' | 'monodepth'
    # loss weights (rpn = KernelHead, rcnn = KernelUpdateHead)
    loss_rank_weight: float = 0.1
    loss_seg_weight: float = 1.0
    loss_mask_weight: float = 1.0
    loss_dice_weight: float = 4.0
    loss_cls_weight: float = 2.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    rpn_depth_loss: DepthLossConfig = DepthLossConfig(loss_weight=5.0)
    rcnn_depth_loss: DepthLossConfig = DepthLossConfig(loss_weight=5.0)
    rpn_assigner: AssignerConfig = AssignerConfig()
    rcnn_assigner: AssignerConfig = AssignerConfig()
    # test cfg
    max_per_img: int = 100
    overlap_thr: float = 0.6
    instance_score_thr: float = 0.3
    # bf16 fusion: thing rows with full render capacity; the rest fold into
    # the K3 kernel's max channel (53 + 11 stuff = 64 rows)
    fusion_full_things: int = 53
    # the ASPP auxiliary semantic head (reference semantic_out_cfg; off in
    # every shipped config): its map feeds loss_aspp_semseg only
    with_semantic_aspp: bool = False
    aspp_dilations: tuple = (1, 6, 12, 18)
    loss_aspp_weight: float = 1.0
    with_track: bool = False
    track_head: TrackHeadConfig = TrackHeadConfig()
    tracker: TrackerConfig = TrackerConfig()
    max_things: int = 64  # GT thing instances per image after padding
    # SemKITTI-DVPS mode: GT masks downsample with nearest instead of
    # bilinear (reference polyphonic_former.py:77-80)
    semantic_kitti: bool = False
    compute_dtype: str = "float32"  # 'bfloat16': bf16 forward, f32 master weights
    # recompute the backbone in the backward pass (torch.utils.checkpoint)
    remat_backbone: bool = True

    @property
    def num_classes(self) -> int:
        return self.num_thing_classes + self.num_stuff_classes

    @property
    def num_queries(self) -> int:
        """Proposals + stuff kernels."""
        return self.num_proposals + self.num_stuff_classes


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # reference: configs/_base_/datasets/cityscapes_dvps.py
    data_root: str = "data/cityscapes-dvps"
    split: str = "train"
    ref_sample_mode: str = "random"
    ref_seq_index: Tuple[int, ...] = ()
    img_size: Tuple[int, int] = (1024, 2048)  # (H, W) crop / pad target
    ratio_range: Tuple[float, float] = (1.0, 2.0)
    flip_ratio: float = 0.5
    size_divisor: int = 32
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    max_depth: float = 80.0
    repeat_times: int = 8
    batch_size: int = 8  # global batch
    num_workers: int = 8
    check_id_match: int = 80000
    shuffle: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    lr: float = 1e-4
    weight_decay: float = 0.05
    backbone_lr_mult: float = 0.25
    grad_clip_norm: float = 1.0
    warmup_iters: int = 1000
    warmup_ratio: float = 0.001
    lr_decay_epochs: Tuple[int, ...] = (16, 22)
    lr_decay_factor: float = 0.1
    total_epochs: int = 24
    checkpoint_interval: int = 1  # epochs
    max_keep_checkpoints: int = 2
    log_interval: int = 50  # steps


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    work_dir: str = "work_dirs/default"
    seed: int = 0
    load_from: Optional[str] = None
    resume: bool = False


def _debug_tiny() -> ExperimentConfig:
    """Narrow widths and small crops for the CPU tests."""
    return ExperimentConfig(
        model=ModelConfig(out_channels=64, fpn_out_channels=64, feedforward_channels=128,
                          num_proposals=20, max_things=8),
        data=DataConfig(img_size=(128, 256), ratio_range=(1.0, 1.1), batch_size=1,
                        num_workers=1, repeat_times=1),
        schedule=ScheduleConfig(warmup_iters=10, total_epochs=1, lr_decay_epochs=(1,),
                                log_interval=1),
        work_dir="work_dirs/debug_tiny")


def _debug_tiny_video() -> ExperimentConfig:
    cfg = _debug_tiny()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, with_track=True),
                               data=dataclasses.replace(cfg.data, ref_seq_index=(-1, 1)))


# backbone -> (embed dim, blocks per stage, heads per stage); JAX
# models/polyphonic.py, the Swin branch of PolyphonicFormer.setup
SWIN_SPECS = {"swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
              "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48))}
# backbone -> STDC blocks per stage; the STDC branch of the same setup
STDC_LAYERS = {"stdc813": (2, 2, 2), "stdc1446": (4, 5, 3)}


def _video_r50_1x() -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(with_track=True, rpn_depth_loss=DepthLossConfig(loss_weight=1.0)),
        data=DataConfig(ref_seq_index=(-2, -1, 1, 2), repeat_times=4, batch_size=16),
        schedule=ScheduleConfig(lr=2e-4, total_epochs=12, lr_decay_epochs=(8, 11)),
        work_dir="work_dirs/poly_r50_video_1x")


def _video_r50_semkitti_1x() -> ExperimentConfig:
    """SemKITTI-DVPS: the video model with the nearest GT downsample, on
    384x1248 crops of the SemKITTI-DVPS frames (the Cityscapes-DVPS
    ``video_sequence`` layout)."""
    cfg = _video_r50_1x()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, semantic_kitti=True),
        data=dataclasses.replace(cfg.data, data_root="data/semkitti-dvps",
                                 img_size=(384, 1248), ratio_range=(1.0, 2.0)),
        work_dir="work_dirs/poly_r50_semkitti_1x")


def _video_swinl() -> ExperimentConfig:
    """The video model on Swin-L, served in bf16 (BASELINE.json config #5)."""
    cfg = _video_r50_1x()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone="swin_large", compute_dtype="bfloat16"),
        work_dir="work_dirs/poly_swinl_video")


PRESETS = {
    # reference configs/polyphonic_image/poly_r50_cityscapes_2x.py
    "image_r50_2x": lambda: ExperimentConfig(work_dir="work_dirs/poly_r50_image_2x"),
    # reference configs/polyphonic_video/poly_r50_cityscapes_1x.py
    "video_r50_1x": _video_r50_1x,
    # the JAX package's video_r50_semkitti_1x (semantic_kitti mode)
    "video_r50_semkitti_1x": _video_r50_semkitti_1x,
    # the JAX package's video_swinl: video_r50_1x on swin_large, in bf16
    "video_swinl": _video_swinl,
    "debug_tiny": _debug_tiny,
    "debug_tiny_video": _debug_tiny_video,
}


def preset(name: str) -> ExperimentConfig:
    """The JAX package's ``get_preset(name)``, restricted to the fields the
    port reads."""
    return PRESETS[name]()


# the JAX package's name, so the CLIs read the same
get_preset = preset


def model_preset(name: str, **replacements) -> ModelConfig:
    """The model configuration of the JAX package's preset ``name``
    (``get_preset(name).model``), with ``replacements`` applied."""
    return dataclasses.replace(preset(name).model, **replacements)


def _replace_path(obj: Any, path: Sequence[str], value: Any) -> Any:
    if not path:
        return value
    field_name = path[0]
    sub = getattr(obj, field_name)
    new_sub = _replace_path(sub, path[1:], value)
    return dataclasses.replace(obj, **{field_name: new_sub})


def apply_overrides(cfg: Any, overrides: dict) -> Any:
    """Apply flat dotted-path overrides, e.g. {'schedule.lr': 2e-4}; a copy
    of the JAX package's ``configs/config.py::apply_overrides``.

    Values are coerced to the existing field's type where sensible; this is
    the equivalent of the reference's ``--cfg-options``
    (tools/train.py:64-73).
    """
    for key, value in overrides.items():
        path = key.split(".")
        node = cfg
        for p in path[:-1]:
            node = getattr(node, p)
        old = getattr(node, path[-1])
        if isinstance(value, str) and old is not None and not isinstance(old, str):
            if isinstance(old, bool):
                value = value.lower() in ("1", "true", "yes")
            elif isinstance(old, int):
                value = int(value)
            elif isinstance(old, float):
                value = float(value)
            elif isinstance(old, tuple):
                elt = type(old[0]) if old else float
                # accept both "a,b" and "(a,b)" / "[a,b]" spellings
                value = tuple(elt(v) for v in
                              value.strip("()[] ").split(","))
        cfg = _replace_path(cfg, path, value)
    return cfg


def parse_overrides(pairs) -> dict:
    """``["a.b=1", ...]`` (the CLIs' ``--set``) -> ``{"a.b": "1"}``; the JAX
    package's ``tools/train.py::parse_overrides``."""
    out = {}
    for pair in pairs or []:
        key, value = pair.split("=", 1)
        out[key] = value
    return out
