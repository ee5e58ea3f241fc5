"""Idle ms of the card a trained sample put down to the backward
(``train/backward``, the autograd engine's thread with it), from the span
pass."""
from benchmark.metrics._common import span_ms

SPANS = ("train/backward",)


def read(trace):
    return span_ms(trace, "train", SPANS, "idle")
