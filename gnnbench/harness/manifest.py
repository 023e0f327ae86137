"""`BENCHMARK.json` and the files it names: a cell's configuration, its
traffic mix and the readers of its per-layer metrics are found by name,
so that a new cell, mix or metric is a new file and no edit.

    configs/<config>.json    the configuration (its `file` in BENCHMARK.json)
    traffic/<traffic>.json   the mix: "loop" is "train" or "serve", and its knobs
    metrics/<metric>.py      read(ctx, part) -> float or None, for the
                             metric `<metric>` or `<metric>.<part>`
    reference/<module>.py    the plain reference a configuration names
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

__all__ = ["Cell", "load_cell", "metrics_of", "metric_reader", "reference_module"]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    manifest: Dict

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with its configuration and
    traffic mix read. Raises KeyError for an unknown cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "gnnbench", "traffic", f"{w['traffic']}.json")) as fh:
        traffic = json.load(fh)
    if traffic.get("loop") not in ("train", "serve"):
        raise ValueError(f"traffic {w['traffic']!r}: loop must be 'train' or 'serve'")
    return Cell(name, int(w["chips"]), config, traffic, manifest)


def metrics_of(cell: Cell, kind: str) -> List[Dict]:
    """The cell's `end_to_end` or `per_layer` metrics: those that list it
    under `workloads`; without the key, every end-to-end metric, and the
    per-layer metrics whose `moves` the cell reports."""
    e2e = [m for m in cell.manifest["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in cell.manifest["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def metric_reader(name: str) -> Callable:
    """`read` of metrics/<base>.py for the metric `<base>[.<part>]`."""
    base = name.split(".", 1)[0]
    return importlib.import_module(f"gnnbench.metrics.{base}").read


def reference_module(config: Dict):
    return importlib.import_module(f"gnnbench.reference.{config['reference']['module']}")
