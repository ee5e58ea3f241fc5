"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its 700 W
limit): HBM bandwidth and the arithmetic rate of each compute dtype.  A card
set below 700 W runs slower; the benchmark prints its ``power.limit`` beside
every share of these peaks."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# TF32 off: float32 runs outside the tensor cores
FLOPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

_NAMES = {"float": "float32", "c10::BFloat16": "bfloat16", "c10::Half": "float16",
          "torch.float32": "float32", "torch.bfloat16": "bfloat16",
          "torch.float16": "float16"}


def dtype_name(name: str) -> str:
    """A profiler or torch dtype name -> a key of FLOPS_PER_S (other dtypes,
    such as integers, count as float32)."""
    return _NAMES.get(str(name), "float32")


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[dtype_name(dtype)])
