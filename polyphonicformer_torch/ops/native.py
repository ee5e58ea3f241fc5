"""The port's native host library: the VPQ statistics core (a copy of the
JAX package's ``native/vpq_core.cpp``), the PNG scanline unfilter and
cv2's fixed-point bilinear resize of uint8 images, all in
``polyphonicformer_torch/native/``.

The sources compile with one ``g++ -O3`` the first time a function here is
called, into ``polyphonicformer_torch/_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, and load through ``ctypes``.  The
build writes a temporary file and renames it into place, so processes that
build at once (test workers, decode workers) never load a partial file.
There is no fallback: a library that does not build or load raises.  The
Python VPQ of ``evalutils/vpq.py`` is the plain version the tests hold this
one to, ``data/png.py::unfilter_plain`` the unfilter's and
``data/resize.py::resize_linear_u8_plain`` the resize's.  Importing this
module builds nothing and imports no ``torch``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64


def _sources():
    return sorted(SRC_DIR.glob("*.cpp"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpoly_native_{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; raise on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, _sources())]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("native library: g++ not found") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("native library build failed:\n" + " ".join(cmd)
                                   + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.vpq_stats.restype = _I32
        lib.vpq_stats.argtypes = [_P, _P, _I64, _I32, _I64, _I64, _P, _P, _P, _P]
        lib.png_unfilter.restype = _I64
        lib.png_unfilter.argtypes = [_P, _P, _I64, _I64, _I32]
        lib.resize_linear_u8.restype = _I64
        lib.resize_linear_u8.argtypes = [_P, _I64, _I64, _I64, _P, _I64, _I64, _P, _P, _P, _P]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def vpq_stats(pred: np.ndarray, gt: np.ndarray, num_classes: int = 19,
              max_ins: int = 10000, ign_id: int = 255
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-category (iou, tp, fn, fp) of one panoptic comparison."""
    pred = np.ascontiguousarray(pred.reshape(-1), np.int64)
    gt = np.ascontiguousarray(gt.reshape(-1), np.int64)
    if pred.size != gt.size:
        raise ValueError(f"vpq_stats: {pred.size} predicted vs {gt.size} GT pixels")
    iou, tp, fn, fp = (np.zeros(num_classes + 1, np.float64) for _ in range(4))
    rc = load().vpq_stats(_ptr(pred), _ptr(gt), pred.size, num_classes, max_ins, ign_id,
                          _ptr(iou), _ptr(tp), _ptr(fn), _ptr(fp))
    if rc != 0:
        raise RuntimeError(f"vpq_stats failed rc={rc}")
    return iou, tp, fn, fp


def png_unfilter(raw: np.ndarray, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reconstruct ``rows`` filtered PNG scanlines (each a filter-type byte
    and ``row_bytes`` bytes, ``raw`` uint8) into a (rows, row_bytes) array."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != rows * (row_bytes + 1):
        raise ValueError(f"png_unfilter: {raw.size} bytes for {rows} rows of {row_bytes}")
    if not 1 <= bpp <= 8:
        raise ValueError(f"png_unfilter: bpp {bpp} not in 1..8")
    out = np.empty((rows, row_bytes), np.uint8)
    rc = load().png_unfilter(_ptr(raw), _ptr(out), rows, row_bytes, bpp)
    if rc != 0:
        row = -rc - 1
        raise ValueError(f"PNG row {row}: unknown filter type {int(raw[row * (row_bytes + 1)])}")
    return out


def resize_linear_u8(img: np.ndarray, dh: int, dw: int, xofs: np.ndarray, xa: np.ndarray,
                     yofs: np.ndarray, yb: np.ndarray) -> np.ndarray:
    """cv2's INTER_LINEAR of a (h, w, c) uint8 image to (dh, dw, c) through
    the tap tables of ``data/resize.py::linear_taps`` (x clamped, y not)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_linear_u8: need (h, w, c) uint8, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    xofs = np.ascontiguousarray(xofs, np.int32)
    yofs = np.ascontiguousarray(yofs, np.int32)
    xa = np.ascontiguousarray(xa, np.int16)
    yb = np.ascontiguousarray(yb, np.int16)
    if xofs.shape != (dw,) or xa.shape != (dw, 2) or yofs.shape != (dh,) or yb.shape != (dh, 2):
        raise ValueError("resize_linear_u8: tap tables do not match the output size")
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    rc = load().resize_linear_u8(_ptr(img), h, w, c, _ptr(out), dh, dw, _ptr(xofs), _ptr(xa),
                                 _ptr(yofs), _ptr(yb))
    if rc != 0:
        raise ValueError(f"resize_linear_u8 failed rc={rc}")
    return out

