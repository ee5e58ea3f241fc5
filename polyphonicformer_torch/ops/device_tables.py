"""Small constant tables copied to the device once.

A copy from host memory would stall the stream on every call, so each
table is kept per (arguments, device).  While a tracer runs
(``torch.export``, fake tensors) the table is built at the call and nothing
is kept: a kept tensor would be a fake one, which a later eager call
cannot use, and an eager tensor would be folded into the traced graph as
it was when it was kept.
"""
from __future__ import annotations

import functools

import torch


def tracing() -> bool:
    """True while ``torch.export``/``torch.compile`` or a fake tensor mode
    traces the caller."""
    from torch._guards import detect_fake_mode

    return torch.compiler.is_compiling() or detect_fake_mode() is not None


def device_table(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function of hashable arguments
    (the device last) that returns a tensor on that device, bypassed while
    :func:`tracing`."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def table(*args):
            return fn(*args) if tracing() else cached(*args)

        table.cache_clear = cached.cache_clear
        return table

    return wrap
