"""K10's share of its roofline in one of its two modes (``poly::relpos_attention``)."""
from __future__ import annotations

from benchmark import roofline


def share(trace, global_mode: bool) -> float | None:
    """The least time (``roofline.least_seconds``) of the shape pass's
    ``poly::relpos_attention`` calls with ``ws = 0`` (``global_mode``) or
    ``ws > 0``, over the device time of the kernels named
    ``relpos_attn_global`` (or ``relpos_attn_window``) in the device pass,
    in %.  Both passes run the same number of profiled steps.  None in a run
    without such calls or kernels (a program without K10)."""
    if trace.kind != "serve":
        return None
    least = 0.0
    for name, shapes, dtypes, scalars in trace.ops:
        if name.split(".", 1)[0] == "poly::relpos_attention" \
                and (int(scalars[4]) == 0) == global_mode:
            least += roofline.least_seconds(name, shapes, dtypes, scalars)
    frag = "relpos_attn_global" if global_mode else "relpos_attn_window"
    device_s = sum(e - s for n, s, e in trace.device if frag in n) / 1e6
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s
