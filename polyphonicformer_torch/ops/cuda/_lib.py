"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ``ctypes``.  The library lands in
``polyphonicformer_torch/_build/`` (git-ignored) under a name keyed by a hash
of the sources and flags, so an edited source rebuilds.  The build happens
the first time any wrapper is called on a CUDA tensor; importing this module
touches neither ``nvcc`` nor the card.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises when that is not 0 and
otherwise adds one to the kernel's launch count.  Each wrapper module
defines its kernel entries as ``poly::`` custom ops (:func:`define_op`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, if this process built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpoly_kernels_{digest.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with the output of a failed one."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            tmp_dir = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
            tmp_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = tmp_dir / f"{src.stem}.o"
                cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                objs.append(str(obj))
                procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
            _run(procs)
            tmp = tmp_dir / so.name
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *objs]
            _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True))])
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
            shutil.rmtree(tmp_dir, ignore_errors=True)
        _lib = ctypes.CDLL(str(so))
        return _lib


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


class Kernel:
    """One C entry point of the library and its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        """Launch on the current CUDA stream (appended as the last argument)."""
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = I32
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def define_op(name: str, schema: str, cpu, cuda, fake):
    """Define the custom op ``poly::<name>`` with ``schema``: ``cpu`` (the
    plain version) runs for CPU tensors, ``cuda`` (the kernel) for CUDA
    tensors and ``fake`` gives the output shapes to tracers.  The
    registrations go straight to the dispatcher's CPU, CUDA and Meta keys,
    with no autograd kernel: a gradient stays in the caller's
    ``torch.autograd.Function``.  Returns the op."""
    qualname = f"poly::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cpu")(cpu)
    torch.library.impl(qualname, "cuda")(cuda)
    torch.library.register_fake(qualname)(fake)
    return getattr(torch.ops.poly, name).default


def check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int | None = None,
               contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor the kernel takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
