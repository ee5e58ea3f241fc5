"""Configuration of the port's serving path.

The fields of ``polyphonicformer_tpu/configs/config.py`` that the port
reads, under the same names and with the same defaults (the reference's
``configs/_base_/models/polyphonic_former.py`` and
``configs/polyphonic_video/poly_r50_cityscapes_1x.py``), so the port and
everything it runs on import nothing of the JAX package.  The training,
data and Swin fields wait for the slices that read them.
``tests/test_torch_configs.py`` holds each preset field for field against
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
    roi_sampling_ratio: int = 2
    featmap_strides: Tuple[int, ...] = (4, 8, 16, 32)
    finest_scale: int = 56


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_thing_classes: int = 8
    num_stuff_classes: int = 11
    num_proposals: int = 100
    num_stages: int = 3
    backbone: str = "resnet50"
    fpn_out_channels: int = 256
    out_channels: int = 256
    num_heads: int = 8
    feedforward_channels: int = 2048
    sem_fpn_gn_groups: int = 32
    hard_mask_thr: float = 0.5
    num_cls_fcs: int = 1
    num_mask_fcs: int = 1
    depth_act_mode: str = "sigmoid"  # 'sigmoid' | 'monodepth'
    # test cfg
    max_per_img: int = 100
    overlap_thr: float = 0.6
    instance_score_thr: float = 0.3
    # bf16 fusion: thing rows with full render capacity; the rest fold into
    # the K3 kernel's max channel (53 + 11 stuff = 64 rows)
    fusion_full_things: int = 53
    with_track: bool = False
    track_head: TrackHeadConfig = TrackHeadConfig()
    tracker: TrackerConfig = TrackerConfig()

    @property
    def num_classes(self) -> int:
        return self.num_thing_classes + self.num_stuff_classes


PRESETS = {
    # reference configs/polyphonic_video/poly_r50_cityscapes_1x.py
    "video_r50_1x": lambda: ModelConfig(with_track=True),
    # narrow widths for the CPU tests
    "debug_tiny_video": lambda: ModelConfig(
        out_channels=64, fpn_out_channels=64, feedforward_channels=128,
        num_proposals=20, with_track=True),
}


def model_preset(name: str, **replacements) -> ModelConfig:
    """The model configuration of the JAX package's preset ``name``
    (``get_preset(name).model``), with ``replacements`` applied."""
    return dataclasses.replace(PRESETS[name](), **replacements)
