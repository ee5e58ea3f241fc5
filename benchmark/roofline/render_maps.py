"""K4, ``poly::render_maps(pix, depth_sel, depth_basic (H, W), labels, seg_ids,
keep, track_ids (K,), num_classes) -> semantic, panoptic, depth, track (H,
W)``: every input read once, the four maps written once; a few selects a
pixel, no arithmetic to speak of."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("map_render",)


def cost(shapes, dtypes, scalars):
    h, w = shapes[0]
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:7], dtypes[:7]))
    return ins + 16 * h * w, 0.0, "float32"
