"""Knob selection from a measured table: the port's tuning layer.

Port of `geot_tpu/tuning/heuristics.py:40-214` (`KernelConfig`,
`select_config`, `select_config_ex`, `load_table`, `table_fingerprint`,
`bucket_key`, `_nearest_key`) with the same vocabulary: a table maps
`op:f:nnz:avg` (the op family, then log2 buckets of the feature width, the
edge count and the average degree) to a `KernelConfig`, whose `mode` is
one of the reference's names. Here "bat" and "bat_packed" build BAT plans
(unpacked, or packed for `feature_hint` <= 64), "sr", "packed" and "pr"
prefer the slot plans, "hybrid" is the stream+gather split, and "xla"
names the port's plain route (`ops.reference`: index_add_ over the edges).

The port's table is its own: `geot_tpu_torch/tuning/table.json`, or the
file named by GEOT_TORCH_TUNING_TABLE. The JAX package's table and its
GEOT_TPU_TUNING_TABLE are TPU measurements and are never read. The
shipped table is empty, and an empty table answers `build_graph`'s
explicit defaults (source "default"): BAT plans of 1024 x 256 tiles, slot
plans of 512 x 256, the BAT preference for every SpMM. The reference's
other answers without a measurement are TPU facts and are not carried
over: its latency floor (the plain route below 12,000 edges) and its
analytic heuristic (1024-edge BAT tiles, 512 x 256 packed BAT below 65
features). A measured key answers itself ("table"); an unswept shape of a
measured family takes the nearest measured bucket ("near"), with the
reference's clamp of slot modes to BAT past 20 M edges.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Tuple

__all__ = [
    "KernelConfig",
    "select_config",
    "select_config_ex",
    "load_table",
    "table_fingerprint",
    "bucket_key",
    "TABLE_ENV",
    "DEFAULT_CONFIG",
    "DEFAULT_KNOBS",
]

TABLE_ENV = "GEOT_TORCH_TUNING_TABLE"
_SHIPPED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "table.json")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    # 'bat' | 'bat_packed' | 'sr' | 'packed' | 'pr' | 'xla' | 'hybrid'
    mode: str
    e_tile: int = 256
    s_tile: int = 128
    f_tile: int = 128

    def key(self) -> str:
        return f"{self.mode}:{self.e_tile}:{self.s_tile}:{self.f_tile}"


# build_graph's knobs where neither the caller nor a measured table sets them
DEFAULT_KNOBS = dict(e_tile=512, s_tile=256, bat_e_tile=1024, bat_s_tile=256, prefer="bat",
                     prefer_dyn="bat", mode_hint="auto")
# an empty table's answer: those knobs' BAT tiles and preference
DEFAULT_CONFIG = KernelConfig(DEFAULT_KNOBS["prefer"], DEFAULT_KNOBS["bat_e_tile"],
                              DEFAULT_KNOBS["bat_s_tile"], 128)

# ((path, mtime), contents) of the table last read
_table_cache: Optional[Tuple[tuple, dict]] = None


def _table_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(TABLE_ENV) or _SHIPPED


def table_fingerprint() -> str:
    """Short hash of the active table's contents ("notable" without one):
    the graph cache's key holds it, so a graph built under another table
    is not served."""
    path = _table_path()
    if not os.path.exists(path):
        return "notable"
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()[:10]


def load_table(path: Optional[str] = None) -> dict:
    """{key: KernelConfig} of the table at `path` (default: the variable's
    file, else the shipped table); read again when the path or the file's
    modification time changes."""
    global _table_cache
    path = _table_path(path)
    tag = (path, os.stat(path).st_mtime_ns if os.path.exists(path) else None)
    if _table_cache is not None and _table_cache[0] == tag:
        return _table_cache[1]
    table = {}
    if tag[1] is not None:
        with open(path) as f:
            raw = json.load(f)
        table = {k: KernelConfig(**v) for k, v in raw.items()}
    _table_cache = (tag, table)
    return table


def _bucket(x: float) -> int:
    """floor(log2(x)) for x >= 1."""
    b = 0
    while (1 << (b + 1)) <= x:
        b += 1
    return b


def bucket_key(n_features: int, nnz: int, num_segments: int) -> str:
    avg = nnz / max(num_segments, 1)
    return f"{_bucket(max(n_features, 1))}:{_bucket(max(nnz, 1))}:{_bucket(max(avg, 1.0))}"


def _nearest_key(table: dict, op: str, kb: str) -> Optional[KernelConfig]:
    """The config of the nearest measured bucket of the same op family by
    L1 distance over (log2 feature, log2 nnz, log2 avg), the feature
    distance weighed double; None where the family has no key. Ties go to
    the first key in the table's order."""
    want = [int(t) for t in kb.split(":")]
    best = None
    prefix = op + ":"
    for key in table:
        if not key.startswith(prefix):
            continue
        have = [int(t) for t in key[len(prefix):].split(":")]
        d = 2 * abs(have[0] - want[0]) + abs(have[1] - want[1]) + abs(have[2] - want[2])
        if best is None or d < best[0]:
            best = (d, table[key])
    return best[1] if best is not None else None


def select_config_ex(
    n_features: int,
    nnz: int,
    num_segments: int,
    *,
    op: str = "spmm",
    dtype_bytes: int = 4,
) -> Tuple[KernelConfig, str]:
    """(config, source): source "table" (the exact measured key), "near"
    (the nearest measured bucket of `op`'s family) or "default" (no
    measurement of the family: `DEFAULT_CONFIG`). `op` is the table family:
    "spmm" (the graph's or no weights), "spmm_dyn" (per-call weights) or
    "index_scatter"."""
    del dtype_bytes
    table = load_table()
    if table:
        kb = bucket_key(n_features, nnz, num_segments)
        if f"{op}:{kb}" in table:
            return table[f"{op}:{kb}"], "table"
        near = _nearest_key(table, op, kb)
        if near is not None:
            if nnz > 20_000_000 and near.mode in ("sr", "packed", "pr"):
                # slot layouts are not measured past 20 M edges (the sweep
                # skips them): a slot winner there is an extrapolation
                near = KernelConfig("bat", near.e_tile, near.s_tile, near.f_tile)
            return near, "near"
    return DEFAULT_CONFIG, "default"


def select_config(
    n_features: int,
    nnz: int,
    num_segments: int,
    *,
    op: str = "spmm",
    dtype_bytes: int = 4,
) -> KernelConfig:
    """`select_config_ex`'s config."""
    return select_config_ex(n_features, nnz, num_segments, op=op, dtype_bytes=dtype_bytes)[0]
