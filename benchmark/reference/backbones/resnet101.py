"""ResNet-101 (He et al. 2016, mmdet 'pytorch' style) under the 4-level FPN."""
from benchmark.reference.models.fpn import FPN
from benchmark.reference.models.resnet import ResNet


def build(cfg):
    backbone = ResNet("resnet101")
    backbone.freeze(cfg.frozen_stages)
    return backbone, FPN(backbone.out_channels, cfg.fpn_out_channels)
