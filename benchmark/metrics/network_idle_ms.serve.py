"""Idle ms of the card a served frame put down to the network (``serve/network``:
backbone, neck, kernel head and update stages), from the span pass."""
from benchmark.metrics._common import span_ms

SPANS = ("serve/network",)


def read(trace):
    return span_ms(trace, "serve", SPANS, "idle")
