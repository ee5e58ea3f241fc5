"""Idle ms of the card a trained sample put down to the forward and losses
(``train/prep``, ``cast``, ``forward_losses``), from the span pass."""
from benchmark.metrics._common import span_ms

SPANS = ("train/prep", "train/cast", "train/forward_losses")


def read(trace):
    return span_ms(trace, "train", SPANS, "idle")
