"""Byte and operation counts of the program's hand-written kernels.

One file per ``poly::`` op, named after the op (``poly::mask_pool`` ->
``mask_pool.py``), each with ``cost(shapes, dtypes, scalars) -> (bytes,
flops, dtype)``: the bytes of every input read once and every output written
once, the operations the op's algorithm needs, and the dtype whose peak
bounds them, all from the call's shapes as the profiler records them
(``record_shapes``).  :func:`least_seconds` turns a call into its least time
at the card's peaks (:mod:`.peaks`).  The per-configuration FLOPs of a whole
step are in :mod:`.model_flops`.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

from .peaks import least_seconds as _least

_HERE = Path(__file__).resolve().parent
_CACHE: dict = {}

SIZES = {"float32": 4, "float": 4, "int": 4, "int32": 4, "bfloat16": 2, "c10::BFloat16": 2,
         "c10::Half": 2, "bool": 1, "long int": 8, "int64": 8, "unsigned char": 1}


def itemsize(dtype: str) -> int:
    return SIZES.get(str(dtype), 4)


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nbytes(shape, dtype) -> int:
    return numel(shape) * itemsize(dtype)


def formula(op: str):
    """The formula module of ``poly::<op>``, or None when the op has none."""
    short = op.split("::", 1)[-1].split(".", 1)[0]
    if short not in _CACHE:
        path = _HERE / f"{short}.py"
        mod = None
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"benchmark.roofline.{short}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _CACHE[short] = mod
    return _CACHE[short]


def least_seconds(op: str, shapes, dtypes, scalars) -> float | None:
    """The least time of one call of ``op``, or None without a formula."""
    mod = formula(op)
    if mod is None:
        return None
    b, f, dt = mod.cost(shapes, dtypes, scalars)
    return _least(b, f, dt)
