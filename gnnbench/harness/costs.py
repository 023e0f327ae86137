"""The yardstick of work: each operation's flops and least bytes from its
shapes, and its least time on a card from the table of published peaks.

A configuration lists the operations its model needs (`ops`), each with a
kind below and its shapes as numbers or expressions over the graph's
dimensions (N nodes, E edges as the model sees them, T training nodes, P
parameters). Bytes count each input read once and each output written
once, in float32 with int32 indices, whatever an implementation reads
again: for an aggregation x's rows once, the source, weight and row-offset
streams once, the output once.
"""

from __future__ import annotations

import ast
import json
import os
import operator
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["evaluate", "op_cost", "least_time", "load_peaks", "PEAKS_FILE"]

PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "peaks.json")
F32, I32 = 4, 4

_BIN = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Div: operator.truediv}


def evaluate(expr, dims: Dict[str, float]) -> float:
    """A number, or an arithmetic expression (+ - * / //, parentheses)
    over the names in `dims`."""
    if isinstance(expr, (int, float)):
        return expr

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            return dims[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN:
            return _BIN[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(f"not an arithmetic expression: {expr!r}")

    return ev(ast.parse(str(expr), mode="eval"))


def op_cost(op: Dict, dims: Dict[str, float]) -> Tuple[float, float]:
    """(flops, bytes) of one operation of a configuration's `ops`."""
    a = {k: evaluate(v, dims) for k, v in op.items() if k not in ("op", "in", "kind")}
    kind = op["kind"]
    if kind == "gemm":
        m, k, n = a["m"], a["k"], a["n"]
        return 2.0 * m * k * n, F32 * (m * k + k * n + m * n)
    if kind == "spmm":
        e, w = a["edges"], a["width"]
        nbytes = (F32 * a["src_rows"] * w + I32 * e + F32 * e * a.get("weights", 0)
                  + I32 * (a["rows"] + 1) + F32 * a["rows"] * w)
        return 2.0 * e * w, nbytes
    if kind == "sddmm":
        e, w, h = a["edges"], a["width"], a["heads"]
        nbytes = (F32 * (a["rows_a"] + a["rows_b"]) * w + I32 * (e + a["rows_a"] + 1)
                  + F32 * e * h)
        return 2.0 * e * w, nbytes
    if kind == "edge_softmax":
        e, h, n = a["edges"], a["heads"], a["rows"]
        # per-node logit terms read, indices read, attention written
        nbytes = F32 * 2 * n * h + I32 * (e + n + 1) + F32 * e * h
        return 5.0 * e * h, nbytes
    if kind == "elementwise":
        el = a["elems"]
        return el * a.get("flops", 1), F32 * el * (a["reads"] + a["writes"])
    raise ValueError(f"unknown op kind {kind!r}")


def load_peaks(device_name: str, path: str = PEAKS_FILE) -> Optional[Dict[str, float]]:
    """The published peaks of a card by its name, or None."""
    with open(path) as fh:
        table = json.load(fh)
    entry = table.get(device_name)
    return entry if isinstance(entry, dict) else None


def least_time(ops: Iterable[Dict], mode: str, dims: Dict[str, float], peaks: Dict[str, float],
               matmul_flops: float, kinds: Optional[Tuple[str, ...]] = None) -> float:
    """Seconds: the sum over the operations of `mode` ("serve" or "train";
    of the kinds named, or all) of the larger of flops at the peak (GEMMs
    at `matmul_flops`, the rest at the float32 peak) and bytes at the
    memory rate."""
    total = 0.0
    for op in ops:
        if op["in"] not in (mode, "both") or (kinds and op["kind"] not in kinds):
            continue
        flops, nbytes = op_cost(op, dims)
        rate = matmul_flops if op["kind"] == "gemm" else peaks["float32_flops"]
        total += max(flops / rate, nbytes / peaks["hbm_bytes_per_s"])
    return total
