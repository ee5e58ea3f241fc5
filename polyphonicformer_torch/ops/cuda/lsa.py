"""Batched exact linear-sum assignment, K5.

Replaces ``polyphonicformer_tpu/ops/pallas/lsa.py::solve_lsa_pallas``: the
rectangular Jonker-Volgenant solver (one shortest augmenting path per
valid row, ties to the lowest column), one problem per CUDA block
(``csrc/lsa.cu``; the source note there gives the bound and design).  Its
plain version, :func:`solve_lsa_plain`, is the lax solver of
``polyphonicformer_tpu/ops/hungarian.py::solve_lsa`` written with torch
ops, one problem at a time, with the loop conditions read on the host.

Both take costs already prepared by ``ops/hungarian.py``: invalid rows set
to 0 and non-finite entries clamped.
"""
from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.Kernel("poly_lsa", [_lib.P, _lib.P, _lib.P, _lib.I32, _lib.I32, _lib.I32])

_INF = 1e30
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def smem_bytes(g: int, p: int) -> int:
    """Shared memory of one problem (``smem_bytes`` in ``csrc/lsa.cu``)."""
    return (g * p + g + 2 * p) * 4 + (3 * p + 2 * g) * 4


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
    """costs (N, G, P) f32 with G <= P, valid (N, G) bool -> (N, G) int32
    assigned column per row, -1 for invalid rows.  ``steps``: a list that
    gets each problem's number of Dijkstra steps (the kernel's serial
    chain: one block-wide argmin each)."""
    return torch.stack([_solve_one(c, v, steps) for c, v in zip(costs.float(), valid)]) \
        if costs.shape[0] else torch.empty(valid.shape, dtype=torch.int32, device=costs.device)


def _solve_lsa_cuda(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    _lib.check_cuda("costs", costs, (torch.float32,), ndim=3)
    _lib.check_cuda("valid", valid, (torch.bool,), ndim=2)
    n, g, p = costs.shape
    if valid.shape != (n, g) or valid.device != costs.device:
        raise ValueError(f"valid {tuple(valid.shape)} does not match costs {tuple(costs.shape)}")
    if g > p or p > 1024 or smem_bytes(g, p) > _SMEM_LIMIT:
        raise ValueError(f"lsa kernel takes G <= P <= 1024 within shared memory, got {g}x{p}")
    out = torch.empty((n, g), dtype=torch.int32, device=costs.device)
    if n:
        KERNEL.launch(costs.data_ptr(), valid.data_ptr(), out.data_ptr(), n, g, p)
    return out


def solve_lsa(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched exact LSA on prepared costs: (N, G, P) f32, (N, G) bool ->
    (N, G) int32.  A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version."""
    if costs.is_cuda:
        return _solve_lsa_cuda(costs, valid)
    if costs.device.type == "cpu":
        return solve_lsa_plain(costs, valid)
    raise ValueError(f"solve_lsa: unsupported device {costs.device}")

