"""Device ms a served frame of ViTDet's window-attention sub-layers
(``model/vit_window_attn``: norm1, the pad, qkv, K10's window mode, the
crop, proj), from the span pass."""
from benchmark.metrics._vit_span import device_ms

SPAN = "model/vit_window_attn"


def read(trace):
    return device_ms(trace, SPAN)
