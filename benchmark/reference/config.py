"""The reference's configuration: the ``experiment`` object of a file in
``benchmark/configs/`` as nested attribute namespaces, with the two
properties the model code reads."""
from __future__ import annotations

import json
from types import SimpleNamespace


class _Model(SimpleNamespace):
    @property
    def num_classes(self) -> int:
        return self.num_thing_classes + self.num_stuff_classes

    @property
    def num_queries(self) -> int:
        return self.num_proposals + self.num_stuff_classes


def _ns(obj, cls=SimpleNamespace):
    if isinstance(obj, dict):
        return cls(**{k: _ns(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return tuple(_ns(v) for v in obj)
    return obj


def experiment(config: dict):
    """The experiment namespace of a loaded configuration file."""
    exp = dict(config["experiment"])
    model = _ns(exp.pop("model"), _Model)
    out = _ns(exp)
    out.model = model
    return out


def load(path) -> SimpleNamespace:
    with open(path) as f:
        return experiment(json.load(f))
