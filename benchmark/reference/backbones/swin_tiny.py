"""Swin-T (Liu et al. 2021, arXiv:2103.14030: C 96, depths 2-2-6-2, heads
3-6-12-24, window 7) under the 4-level FPN; no stage is frozen."""
from benchmark.reference.models.fpn import FPN
from benchmark.reference.models.swin import SwinTransformer

INIT_STD = {"relative_position_bias_table": 0.02}


def build(cfg):
    backbone = SwinTransformer(96, (2, 2, 6, 2), (3, 6, 12, 24))
    return backbone, FPN(backbone.out_channels, cfg.fpn_out_channels)
