"""K9, ``poly::tracker_step(ids, embeds, bboxes, labels, last_frame,
velocities, acc_frames, num_tracklets, bd_embeds, bd_bboxes, bd_labels,
bd_valid, det_bboxes, det_labels, det_embeds, det_valid (B, D), frame_ids,
thr, memo_tracklet_frames, with_cats, match_metric) -> new state, ids (B, D)
i32, order (B, D) i64, kept (B, D) bool``: the B clips' state and
detections read once, the new state and the three per-detection outputs
written once (1.91 MB at B 4, D 64, T 128, BD 64, E 256).

Bytes only.  The kernel's work (the sort, IoU tests, score products and the
greedy's serial steps) grows with the valid detections and tracklets, which
are device values the trace cannot see; counted from the shapes it would
bound the op by rows that are mostly padding.  So no operation count and no
latency bound: the bytes bound is the least time."""
from benchmark.roofline import nbytes

DEVICE_NAMES = ("tracker_step",)

STATE = 12  # TrackerState's fields, the op's first inputs


def cost(shapes, dtypes, scalars):
    ins = sum(nbytes(s, d) for s, d in zip(shapes[:STATE + 5], dtypes[:STATE + 5]))
    state = sum(nbytes(s, d) for s, d in zip(shapes[:STATE], dtypes[:STATE]))
    b, d = shapes[STATE + 3]
    return ins + state + (4 + 8 + 1) * b * d, 0.0, "float32"
