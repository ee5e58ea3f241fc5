"""Demo CLI: panoptic+depth inference on arbitrary PNG images, saved as
colorized visualizations (panoptic overlay + depth map); the port of
``polyphonicformer_tpu/tools/demo.py``, with the same flags plus
``--device``.

    python -m polyphonicformer_torch.tools.demo img.png [...] \\
        --checkpoint vars.pkl [--preset video_r50_1x] [--device cpu]

Images are read and written through ``data/png.py`` (PNG only; no cv2).
Any image size works: a size that is not a multiple of 32 takes the general
fusion branch.  The depth colours are cv2's ``COLORMAP_MAGMA``, stored here
as a 256 x 3 RGB table.  Runs on the CUDA card unless ``--device cpu``; with
no card it raises.

reference capability: demo/ (visualization of predictions).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# thing-first palette (reference datasets/cityscapes_dvps.py:37-86)
PALETTE = np.asarray([
    (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
    (0, 60, 100), (0, 80, 100), (0, 0, 230), (119, 11, 32),
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (0, 0, 0),
], np.uint8)

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_MAGMA) as
# RGB rows (tests/test_torch_evalutils.py holds it to cv2)
MAGMA_RGB = np.frombuffer(bytes.fromhex(
    "00000401000501010601010802010902020b02020d03030f030312040414050416060518"
    "06051a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31"
    "130d34140e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e"
    "22115024125325125527125829115a2a115c2c115f2d11612f1163311165331067341069"
    "36106b38106c390f6e3b0f703d0f713f0f72400f74420f75440f76451077471078491078"
    "4a10794c117a4e117b4f127b51127c52137c54137d56147d57157e59157e5a167e5c167f"
    "5d177f5f187f601880621980641a80651a80671b80681c816a1c816b1d816d1d816e1e81"
    "701f81721f817320817521817621817822817922827b23827c23827e2482802582812581"
    "8326818426818627818827818928818b29818c29818e2a81902a81912b81932b80942c80"
    "962c80982d80992d809b2e7f9c2e7f9e2f7fa02f7fa1307ea3307ea5317ea6317da8327d"
    "aa337dab337cad347cae347bb0357bb2357bb3367ab5367ab73779b83779ba3878bc3978"
    "bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c83e73ca3e72cc3f71cd4071cf4070"
    "d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476adc4869de4968df4a68e04c67"
    "e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb5760ec5860ed5a5fee5b5e"
    "ef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf66c5cf66e5cf7705c"
    "f7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835ffb8560fb8761"
    "fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b6bfe9d6c"
    "fe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afeb47b"
    "feb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1"
    "fde2a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8"
    "fcf7b9fcf9bbfcfbbdfcfdbf"), np.uint8).reshape(256, 3)


def colorize_panoptic(semantic: np.ndarray, panoptic: np.ndarray) -> np.ndarray:
    """Class colors with per-instance brightness jitter."""
    rgb = PALETTE[np.clip(semantic, 0, 19)]
    rng = np.random.RandomState(0)
    out = rgb.astype(np.int32)
    for sid in np.unique(panoptic):
        if sid == 0:
            continue
        jitter = rng.randint(-40, 40, (3,))
        out[panoptic == sid] = np.clip(out[panoptic == sid] + jitter, 0, 255)
    return out.astype(np.uint8)


def colorize_depth(depth: np.ndarray, max_depth: float = 80.0) -> np.ndarray:
    """RGB MAGMA colours, near bright and far dark."""
    d = np.clip(depth / max_depth, 0, 1)
    d8 = (255 * (1 - d)).astype(np.uint8)
    return MAGMA_RGB[d8]


def main(argv=None) -> list:
    """Returns the paths written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="+", help="input PNG image paths")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on request)")
    args = ap.parse_args(argv)

    import torch

    from ..data.pipeline import make_test_input
    from ..data.png import imread_rgb, write_png
    from ..infer.pipeline import make_image_step
    from ._cli import experiment, load_model, select_device

    dev = select_device(args.device)
    exp = experiment(args.preset)
    cfg, dc = exp.model, exp.data
    model = load_model(args.checkpoint, cfg, dev)

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for path in args.images:
        img = imread_rgb(path)
        frame = dict(img=img, seq_id=0, img_id=0)
        inp = make_test_input(frame, dc)
        step = make_image_step(model, cfg, inp["ori_hw"])  # images may differ in size
        res = step(torch.from_numpy(inp["image"])[None].to(dev))
        sem = res.semantic.cpu().numpy()
        pan = res.panoptic.cpu().numpy()
        depth = res.depth.cpu().numpy()
        vis = colorize_panoptic(sem, pan)
        blend = (0.5 * img + 0.5 * vis).astype(np.uint8)
        stem = os.path.splitext(os.path.basename(path))[0]
        for name, rgb in (("panoptic", blend), ("depth", colorize_depth(depth))):
            out = os.path.join(args.out_dir, f"{stem}_{name}.png")
            write_png(out, rgb)
            written.append(out)
        print(f"{path} -> {args.out_dir}/{stem}_*.png")
    return written


if __name__ == "__main__":
    main()
