"""Graph cache: save and load a built `Graph` as one `.npz`.

Port of `geot_tpu/graph/cache.py` (`save_graph`, `load_graph`,
`cached_build`). The plans are a function of the edges and the knobs, and
building them is most of a large graph's set-up (the products graph's two
64 M-edge BAT plans spend ~9 s each on their edge-row schedules alone),
so a built graph is written once and loaded after. No pickle: the arrays
go into the `.npz` by their path in the graph, and a JSON entry
(`__meta__`) holds the layout (each dataclass's type and fields), the
integers and tuples, and `FORMAT_VERSION`. Every plan family is saved
with its kernel schedules: the edge-row `RowSchedule` of each slot, BAT
and bucketed plan, and each stream family's schedule.

The port keeps its own format and directory; a file of another version,
of another package or of a layout whose fields are not today's classes'
is a miss (`load_graph` returns None) and `cached_build` rebuilds it. As in
the reference, the file name holds the caller's key, the format version
and the fingerprint of the port's tuning table
(`tuning.heuristics.table_fingerprint`): the table picks tiles and
layouts, so a graph built under another table is not served. The
directory is `cache_dir`, else GEOT_GRAPH_CACHE_DIR, else
~/.cache/geot_tpu_torch/graphs; "off" (either way) builds every time and
writes nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from geot_tpu_torch.graph.plan import BatPlan, BucketedBatPlan, SegmentPlan, _sched_key
from geot_tpu_torch.graph.row_schedule import RowSchedule
from geot_tpu_torch.graph.stream_plan import HybridPlan, StreamPlan
from geot_tpu_torch.graph.structures import Graph, count_stream_split
from geot_tpu_torch.tuning.heuristics import table_fingerprint
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["FORMAT_VERSION", "save_graph", "load_graph", "cached_build"]

FORMAT = "geot_tpu_torch.graph"
# bump when a plan's arrays or the plan-building policy change
FORMAT_VERSION = 1
_TYPES = {c.__name__: c for c in (Graph, SegmentPlan, BatPlan, BucketedBatPlan, StreamPlan,
                                  HybridPlan, RowSchedule)}


def _json_default(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    raise TypeError(f"cannot save {type(v).__name__} in a graph file")


def _dump(v, path: str, blobs: dict):
    """The JSON spec of `v`, its tensors put into `blobs` under `path`."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        blobs[path] = v.detach().cpu().numpy()
        return {"tensor": path}
    if dataclasses.is_dataclass(v):
        fields = {}
        for f in dataclasses.fields(v):
            if isinstance(v, RowSchedule) and f.name == "key":
                continue  # the plan's own tensors, set again on load
            fields[f.name] = _dump(getattr(v, f.name), f"{path}.{f.name}", blobs)
        return {"type": type(v).__name__, "fields": fields}
    if isinstance(v, tuple) and any(isinstance(x, torch.Tensor) or dataclasses.is_dataclass(x)
                                    for x in v):
        return {"items": [_dump(x, f"{path}.{i}", blobs) for i, x in enumerate(v)]}
    return {"value": v}


def save_graph(g: Graph, path: str) -> None:
    """Write `g` (every plan family with its schedules, the weights, the
    statics and `build_stats`) to one `.npz` at `path` (written to a
    temporary file and moved into place)."""
    blobs: dict = {}
    spec = _dump(g, "g", blobs)
    meta = {"format": FORMAT, "version": FORMAT_VERSION, "graph": spec}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta, default=_json_default).encode(),
                                      dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **blobs)
    os.replace(tmp, path)


class _Stale(Exception):
    """The file's layout is not today's classes'."""


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _load(spec, z, dev):
    if spec is None:
        return None
    if "tensor" in spec:
        return torch.from_numpy(np.ascontiguousarray(z[spec["tensor"]])).to(dev)
    if "items" in spec:
        return tuple(_load(s, z, dev) for s in spec["items"])
    if "value" in spec:
        v = spec["value"]
        return v if isinstance(v, dict) else _tuplify(v)
    cls = _TYPES.get(spec.get("type"))
    if cls is None:
        raise _Stale(spec.get("type"))
    names = {f.name for f in dataclasses.fields(cls)} - (
        {"key"} if cls is RowSchedule else set())
    if set(spec["fields"]) != names:
        raise _Stale(cls.__name__)
    obj = cls(**{k: _load(s, z, dev) for k, s in spec["fields"].items()})
    rs = getattr(obj, "row_sched", None)
    if rs is not None:  # the schedule is keyed by the plan's own tensors
        obj = dataclasses.replace(obj, row_sched=dataclasses.replace(rs, key=_sched_key(obj)))
    return obj


def load_graph(path: str, device=None) -> Optional[Graph]:
    """The Graph saved at `path`, on `device` (default: the CUDA card), or
    None where the file is of another format, version or layout. A graph
    with hybrid plans adds its split to the process's counter record, as
    `build_graph` does."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("format") != FORMAT or meta.get("version") != FORMAT_VERSION:
            return None
        try:
            g = _load(meta["graph"], z, dev)
        except _Stale:
            return None
    if not isinstance(g, Graph):
        return None
    count_stream_split(g.hyb, g.hyb_t)
    return g


def cached_build(cache_key: str, build_fn: Callable[[], Graph],
                 cache_dir: Optional[str] = None, device=None) -> Graph:
    """The graph of `cache_key` from `cache_dir` (default: the
    GEOT_GRAPH_CACHE_DIR variable, else ~/.cache/geot_tpu_torch/graphs),
    loaded on `device` (default: the CUDA card); or, where there is none
    or it is stale, `build_fn()`, saved there. "off" returns `build_fn()`
    and writes nothing. A file that fails to load is rebuilt; a failed
    write leaves the built graph as it is. `build_stats["cache"]` says
    which it was and how long the load or build took."""
    cache_dir = cache_dir or os.environ.get(
        "GEOT_GRAPH_CACHE_DIR", os.path.expanduser("~/.cache/geot_tpu_torch/graphs"))
    if cache_dir == "off":
        return build_fn()
    path = os.path.join(cache_dir,
                        f"{cache_key}-v{FORMAT_VERSION}-{table_fingerprint()}.npz")
    if os.path.exists(path):
        t0 = time.perf_counter()
        try:
            g = load_graph(path, device=device)
        except (OSError, ValueError, KeyError):
            g = None  # a torn or foreign file: rebuild
        if g is not None:
            g.build_stats["cache"] = {"hit": True, "seconds": time.perf_counter() - t0,
                                      "path": path}
            return g
    t0 = time.perf_counter()
    g = build_fn()
    seconds = time.perf_counter() - t0
    try:
        save_graph(g, path)
    except OSError:
        pass  # a cache that cannot be written must not break the build
    g.build_stats["cache"] = {"hit": False, "seconds": seconds, "path": path}
    return g
