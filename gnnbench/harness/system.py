"""The system under test: the program's graph, model, optimizer and
training step, built as a configuration's `program` entry says. This
module and the stacks of `gnnbench/stacks/` are the only modules of the
benchmark that import the program (`geot_tpu_torch`), and they import it
when called, never at import.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["build_graph", "build_model", "build_train_step", "plan_seconds"]


def _cache_name(config: Dict) -> str:
    blob = json.dumps([config["graph"], config["program"]["prepare_graph"]],
                      sort_keys=True).encode()
    return f"{config['name']}-{hashlib.sha256(blob).hexdigest()[:12]}"


def build_graph(config: Dict, edges: Callable[[], Tuple], device: torch.device,
                cache_dir: Optional[str], log: Callable[[str], None]):
    """The program's `prepare_graph` over the edges, through its graph cache
    in `cache_dir` where the configuration keeps one (`graph_cache`) and
    `cache_dir` is not None."""
    from geot_tpu_torch.graph.cache import cached_build
    from geot_tpu_torch.models import prepare_graph

    kw = dict(config["program"]["prepare_graph"])
    kw["layouts"] = tuple(kw["layouts"])

    def build():
        src, dst, n = edges()
        return prepare_graph(src, dst, n, device=device, **kw)

    name = _cache_name(config)
    if cache_dir is None or not config.get("graph_cache", False):
        log(f"graph cache: off for {name}")
        return build()
    g = cached_build(name, build, cache_dir=cache_dir, device=device)
    info = g.build_stats.get("cache", {})
    path = info.get("path")
    size = os.path.getsize(path) if path and os.path.exists(path) else 0
    log(f"graph cache: {'hit' if info.get('hit') else 'miss'}, {size} bytes, "
        f"{info.get('seconds', 0.0):.3f} s ({path})")
    return g


def plan_seconds(graph) -> float:
    """Host seconds of the graph's plans: the cache's load (or the build it
    timed), else the sum of the build's steps."""
    stats = graph.build_stats
    if "cache" in stats:
        return float(stats["cache"]["seconds"])
    return float(sum(stats.get("seconds", {}).values()))


def build_model(config: Dict, device: torch.device) -> torch.nn.Module:
    """The configuration's model: a class of the program's `models` with its
    arguments (`class`), or a stack of the program's layers that
    `gnnbench/stacks/<stack>.py` builds (`stack`)."""
    spec = config["program"]["model"]
    if "stack" in spec:
        return importlib.import_module(f"gnnbench.stacks.{spec['stack']}").build(config, device)
    import geot_tpu_torch.models as models

    return getattr(models, spec["class"])(*spec["args"], device=device, **spec["kwargs"])


def build_train_step(config: Dict, model: torch.nn.Module):
    """(optimizer, step) of the program's trainer."""
    from geot_tpu_torch.models import make_optimizer, make_train_step

    opt = make_optimizer(model, config["optimizer"]["lr"], config["optimizer"]["weight_decay"])
    has_dropout = config["model"].get("dropout", 0.0) > 0
    return opt, make_train_step(model, opt, has_dropout=has_dropout)
