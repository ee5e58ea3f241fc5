"""The benchmark of ``polyphonicformer_torch`` on NVIDIA cards.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: builds the
program from the seed, warms up every shape the cell's traffic uses, drives
the program's entry for ``--seconds``, then checks what the window produced
against the plain reference (``benchmark/reference``).  With ``--trace 0``
the last line of standard output is one JSON object with the cell's
end-to-end metrics; with ``--trace 1`` the window profiles a stated number
of steps from its middle and the line holds the per-layer metrics, the
device's busy and window seconds and a breakdown.  Every number compared
for ``correct`` is printed beside its limit, last on standard error and
under the line's last key, ``checks``.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result.
"""
from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "polyphonicformer_tpu")


def process_start() -> float:
    """The epoch second this process started (from /proc), or the time
    this module was imported where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What an entry (``benchmark/entries``) gets."""
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    started: float  # epoch second of the process start


@dataclasses.dataclass
class Result:
    """What an entry returns."""
    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict  # name -> value
    memory_peak_bytes: int
    checks: list  # (name, value, limit)
    trace: object = None  # benchmark.trace.Trace of a traced run
    breakdown: dict | None = None
    notes: list = dataclasses.field(default_factory=list)  # earlier stdout lines


def card_power() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(cell: cells.Cell, res: Result, trace: bool, device: dict) -> dict:
    """The result object, ``checks`` last."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(res.trace)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: res.end_to_end[m["name"]] for m in cell.end_to_end}
    checks = [[n, v, lim] for n, v, lim in res.checks]
    correct = bool(checks) and all(v is not None and v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
           "device": device}
    if trace and res.breakdown is not None:
        out["breakdown"] = res.breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def run_cell(ctx: Context) -> Result:
    return cells.entry(ctx.cell.mix).run(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    cell = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=dev, started=started)
    res = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    if args.trace:
        device.update(busy_s=res.trace.busy_s, window_s=res.trace.span_s)
    line = result_line(cell, res, bool(args.trace), device)
    for note in res.notes:
        print(note)
    print(f"card: {card_power()}")
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
