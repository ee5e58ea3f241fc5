"""Swin-L (Liu et al. 2021, arXiv:2103.14030: C 192, depths 2-2-18-2, heads
6-12-24-48, window 7) under the 4-level FPN; no stage is frozen."""
from benchmark.reference.models.fpn import FPN
from benchmark.reference.models.swin import SwinTransformer

INIT_STD = {"relative_position_bias_table": 0.02}


def build(cfg):
    backbone = SwinTransformer(192, (2, 2, 18, 2), (6, 12, 24, 48))
    return backbone, FPN(backbone.out_channels, cfg.fpn_out_channels)
