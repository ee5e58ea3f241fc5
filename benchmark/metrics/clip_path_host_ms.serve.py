"""Host ms a served frame in the per-clip path (``infer/pipeline.py``: fusion,
detections, track embeddings, tracker, render, stack), from the span pass."""
from benchmark.metrics._common import span_ms

SPANS = ("serve/fuse", "serve/detections", "serve/track_embeds", "serve/track",
         "serve/render", "serve/stack")


def read(trace):
    return span_ms(trace, "serve", SPANS, "host")
