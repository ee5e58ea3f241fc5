"""Byte and operation counts of the program's hand-written kernels.

One file per ``poly::`` op, named after the op (``poly::mask_pool`` ->
``mask_pool.py``), each with ``cost(shapes, dtypes, scalars) -> (bytes,
flops, dtype)``: the bytes of every input read once and every output written
once, the operations the op's algorithm needs, and the dtype whose peak
bounds them, all from the call's shapes as the profiler records them
(``record_shapes``).  :func:`least_seconds` turns a call into its least time
at the card's peaks (:mod:`.peaks`).  Each file also names, in
``DEVICE_NAMES``, fragments of its kernels'
device names: the trace counts a kernel whose name holds one as the
program's own (:func:`device_names`).  The per-configuration FLOPs of a
whole step are in :mod:`.model_flops`.
"""
from __future__ import annotations

from pathlib import Path

from ..cells import module
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


def formula(op: str, root: Path | None = None):
    """The formula module of ``poly::<op>`` in ``root`` (default: this
    folder), or None when the op has none."""
    short = op.split("::", 1)[-1].split(".", 1)[0]
    root = _HERE if root is None else Path(root)
    key = (root, short)
    if key not in _CACHE:
        path = root / f"{short}.py"
        _CACHE[key] = module(path, f"benchmark.roofline.{short}") if path.is_file() else None
    return _CACHE[key]


def device_names(root: Path | None = None) -> frozenset:
    """The union of the ``DEVICE_NAMES`` of the files in ``root`` (default:
    this folder)."""
    root = _HERE if root is None else Path(root)
    return frozenset(n for path in sorted(root.glob("[!_]*.py"))
                     for n in getattr(formula(path.stem, root), "DEVICE_NAMES", ()))


def least_seconds(op: str, shapes, dtypes, scalars) -> float | None:
    """The least time of one call of ``op``, or None without a formula."""
    mod = formula(op)
    if mod is None:
        return None
    b, f, dt = mod.cost(shapes, dtypes, scalars)
    return _least(b, f, dt)
