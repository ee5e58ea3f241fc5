"""Idle ms of the card a trained sample put down to the update
(``train/grad_cast``, ``reduce``, ``clip``, ``guard``, ``optimizer``), from
the span pass."""
from benchmark.metrics._common import span_ms

SPANS = ("train/grad_cast", "train/reduce", "train/clip", "train/guard",
         "train/optimizer")


def read(trace):
    return span_ms(trace, "train", SPANS, "idle")
