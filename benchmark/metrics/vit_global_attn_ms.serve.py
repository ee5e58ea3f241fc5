"""Device ms a served frame of ViTDet's global-attention sub-layers
(``model/vit_global_attn``: norm1, qkv, K10's global mode, proj), from the
span pass."""
from benchmark.metrics._vit_span import device_ms

SPAN = "model/vit_global_attn"


def read(trace):
    return device_ms(trace, SPAN)
