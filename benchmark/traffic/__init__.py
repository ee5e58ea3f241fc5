"""Traffic of the benchmark's cells.

A traffic mix is a JSON file of parameters in this folder
(``<traffic>.json``): the entry that drives the program (a module of
``benchmark/entries``), the generator that makes its inputs (a module
here) and the generator's parameters.  Generators are general: a new mix is
a new data file.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def generator(mix: dict):
    """The generator module a mix names."""
    return importlib.import_module(f"{__name__}.{mix['generator']}")
