"""ViTDet ViT-L (Li et al. 2022, arXiv:2203.16527; detectron2
projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py: embed 1024, depth
24, 16 heads of 64, windows of 14 with global blocks 5, 11, 17, 23) under its
simple feature pyramid to ``fpn_out_channels``; no p6.  The rel-pos tables
are drawn at std 0.1, which puts rel_h + rel_w (q . R over 64 channels of a
unit-variance q) on the order of the scaled scores; detectron2 starts them
at zero."""
from benchmark.reference.models.vit import SimpleFeaturePyramid, ViT

INIT_STD = {"pos_embed": 0.02, "rel_pos_h": 0.1, "rel_pos_w": 0.1}


def build(cfg):
    return (ViT(1024, 24, 16, (5, 11, 17, 23), 14),
            SimpleFeaturePyramid(1024, cfg.fpn_out_channels))
