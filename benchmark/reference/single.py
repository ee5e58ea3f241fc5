"""One process, one card: the sums a loss divides are its own."""
from __future__ import annotations


def global_sums(*xs):
    """The inputs themselves, as a tuple (a one-rank all-reduce)."""
    return xs


def data_world() -> int:
    return 1
