"""Batched exact linear-sum assignment, K5.

Replaces ``polyphonicformer_tpu/ops/pallas/lsa.py::solve_lsa_pallas``: the
rectangular Jonker-Volgenant solver (one shortest augmenting path per
valid row, ties to the lowest column) with its preparation of the costs
(invalid rows set to 0, NaN to 1e8, +-inf to +-1e8).  The CUDA kernel
(``csrc/lsa.cu``; the source note there gives the bound and design) solves
each problem in one warp, reads the raw costs through their strides, so a
transposed view needs no copy, and prepares each cost as it reads it; it
is launched as :func:`launch_plan` says.  Its plain version, :func:`solve_lsa_plain`,
is the same preparation and the lax solver of
``polyphonicformer_tpu/ops/hungarian.py::solve_lsa`` written with torch
ops, one problem at a time, with the loop conditions read on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_lsa", [_lib.P, _lib.I64, _lib.I64, _lib.I64, _lib.P, _lib.I64,
                                  _lib.I64, _lib.P, _lib.I32, _lib.I32, _lib.I32, _lib.I32])

_INF = 1e30
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
CPL_INSTANCES = (1, 2, 4, 8, 16, 32)  # the kernel's template instances


class Plan(NamedTuple):
    cpl: int  # columns a lane (the template instance)
    threads: int  # one warp a problem
    smem: int  # bytes of dynamic shared memory a problem


def launch_plan(g: int, p: int) -> Plan:
    """The kernel's launch for (g, p) problems, as ``poly_lsa`` in the
    source takes it: the least instance with 32 * cpl >= p columns, one warp,
    and shared memory for the costs at an odd row stride, the 32 * cpl - p
    words past them that the slots beyond p read, u, col4row and the valid
    bitmask."""
    if p > 32 * CPL_INSTANCES[-1]:
        raise ValueError(f"lsa kernel takes at most {32 * CPL_INSTANCES[-1]} columns, got {p}")
    cpl = next(c for c in CPL_INSTANCES if 32 * c >= p)
    return Plan(cpl, 32, 4 * (g * (p | 1) + 32 * cpl - p + 2 * g + -(-g // 32)))


def prepare(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The preparation of ``solve_lsa_pallas``: f32, invalid rows 0,
    non-finite entries clamped to +-1e8 (NaN to 1e8)."""
    cost = torch.where(valid[:, :, None], costs.float(), 0.0)
    return torch.nan_to_num(cost, nan=1e8, posinf=1e8, neginf=-1e8)


def _solve_one(cost: torch.Tensor, valid: torch.Tensor, steps: list | None) -> torch.Tensor:
    g, p = cost.shape
    n_steps = 0
    dev = cost.device
    u = torch.zeros(g, dtype=torch.float32, device=dev)
    v = torch.zeros(p, dtype=torch.float32, device=dev)
    row4col = torch.full((p,), -1, dtype=torch.int32, device=dev)
    col4row = torch.full((g,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(g, device=dev)
    for cur in [r for r, ok in enumerate(valid.tolist()) if ok]:
        # Dijkstra from row `cur` until an unassigned column is reached
        i, min_val = cur, torch.zeros((), dtype=torch.float32, device=dev)
        remaining = torch.ones(p, dtype=torch.bool, device=dev)
        spc = torch.full((p,), _INF, dtype=torch.float32, device=dev)
        path = torch.full((p,), -1, dtype=torch.int32, device=dev)
        scanned = torch.zeros(g, dtype=torch.bool, device=dev)
        while True:
            n_steps += 1
            scanned[i] = True
            r = min_val + cost[i] - u[i] - v
            better = (r < spc) & remaining
            spc = torch.where(better, r, spc)
            path = torch.where(better, i, path)
            masked = torch.where(remaining, spc, _INF)
            j = int(torch.argmin(masked))  # the first index of the minimum
            min_val = masked[j]
            remaining[j] = False
            if int(row4col[j]) < 0:
                sink = j
                break
            i = int(row4col[j])
        # dual updates
        u[cur] += min_val
        other = scanned & (rows != cur)
        u = u + torch.where(other, min_val - spc[col4row.clamp(0, p - 1).long()], 0.0)
        v = torch.where(~remaining, v - (min_val - spc), v)
        # augment along the alternating path ending at the sink
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            nxt = int(col4row[i])
            col4row[i] = j
            j = nxt
            if i == cur:
                break
    if steps is not None:
        steps.append(n_steps)
    return torch.where(valid, col4row, -1)


def solve_lsa_plain(costs: torch.Tensor, valid: torch.Tensor,
                    steps: list | None = None) -> torch.Tensor:
    """costs (N, G, P) with G <= P, valid (N, G) bool -> (N, G) int32
    assigned column per row, -1 for invalid rows; the costs are prepared
    first (:func:`prepare`).  ``steps``: a list that gets each problem's
    number of Dijkstra steps (the kernel's serial chain: one warp-wide
    argmin each)."""
    if not costs.shape[0]:
        return torch.empty(valid.shape, dtype=torch.int32, device=costs.device)
    return torch.stack([_solve_one(c, v, steps) for c, v in zip(prepare(costs, valid), valid)])


def _solve_lsa_cuda(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    _lib.check_cuda("costs", costs, (torch.float32,), ndim=3, contiguous=False)
    _lib.check_cuda("valid", valid, (torch.bool,), ndim=2, contiguous=False)
    n, g, p = costs.shape
    if valid.shape != (n, g) or valid.device != costs.device:
        raise ValueError(f"valid {tuple(valid.shape)} does not match costs {tuple(costs.shape)}")
    if g > p:
        raise ValueError(f"lsa kernel takes G <= P, got {g}x{p}")
    plan = launch_plan(g, p)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"lsa kernel: a {g}x{p} problem needs {plan.smem} bytes of shared memory")
    out = torch.empty((n, g), dtype=torch.int32, device=costs.device)
    if n and g:
        KERNEL.launch(costs.data_ptr(), *costs.stride(), valid.data_ptr(), *valid.stride(),
                      out.data_ptr(), n, g, p, plan.cpl)
    return out


def solve_lsa(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched exact LSA on raw costs: (N, G, P) f32 of any strides, (N, G)
    bool -> (N, G) int32.  A CUDA tensor launches the kernel, which
    prepares the costs as it reads them; a CPU tensor takes the plain
    version."""
    if costs.is_cuda:
        return _solve_lsa_cuda(costs, valid)
    if costs.device.type == "cpu":
        return solve_lsa_plain(costs, valid)
    raise ValueError(f"solve_lsa: unsupported device {costs.device}")
