"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A workload names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); its limits for ``correct`` are in
``limits/<workload>.json``; each per-layer metric is a reader
``metrics/<name>.py``.  A configuration's backbone and neck are
``reference/backbones/<backbone>.py``; a kernel's roofline formula and
device names are ``roofline/<op>.py``.  Adding a cell, a configuration (with
a new backbone), a mix, a kernel or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_path: Path
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_path: Path | None = None, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``bench_path`` (default: the repository's
    ``BENCHMARK.json``), its files under ``root`` (default: this folder)."""
    root = HERE if root is None else Path(root)
    bench_path = ROOT / "BENCHMARK.json" if bench_path is None else Path(bench_path)
    with open(bench_path) as f:
        bench = json.load(f)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    w = by_name[workload]
    config_path = root / "configs" / f"{w['config']}.json"
    with open(config_path) as f:
        config = json.load(f)
    with open(root / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    mix["name"] = w["traffic"]
    with open(root / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config_path=config_path, config=config,
                mix=mix, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def module(path: Path, name: str):
    """The module of the file ``path``, executed afresh under the dotted
    ``name`` (its package resolves relative imports)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path | None = None):
    """``read(trace) -> float | None`` of ``metrics/<name>.py``."""
    root = HERE if root is None else Path(root)
    return module(root / "metrics" / f"{name}.py", f"benchmark.metrics.{name}").read


def entry(mix: dict):
    """The module of ``entries/`` that drives the mix's program entry."""
    return importlib.import_module(f"benchmark.entries.{mix['entry']}")
