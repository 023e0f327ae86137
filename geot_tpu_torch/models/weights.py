"""Carry GCN, GraphSAGE and GAT parameters between the reference's flax
layout and the port.

The flax tree of `geot_tpu.models.GCN` holds, for layer i,
`GCNConv_{i}/Dense_0/kernel` [in, out] and `GCNConv_{i}/bias` [out]; the
port's `GCN` keeps them as `convs.{i}.lin.weight` [out, in] (the kernel
transposed) and `convs.{i}.bias`. The tree of `geot_tpu.models.GraphSAGE`
holds `SAGEConv_{i}/Dense_0` {kernel, bias} (on the aggregate) and
`SAGEConv_{i}/Dense_1` {kernel} (on the root); the port's `GraphSAGE`
keeps them as `convs.{i}.lin_l.{weight, bias}` and `convs.{i}.lin_r.weight`.
The tree of `geot_tpu.models.GAT` holds `GATConv_{i}/Dense_0/kernel` [in,
heads*features], `att_src` and `att_dst` [1, heads, features] and `bias`;
the port's `GAT` keeps them as `convs.{i}.lin.weight` (transposed),
`convs.{i}.att_src`, `convs.{i}.att_dst` and `convs.{i}.bias`.
`params_from_flax` and `params_to_flax` are inverses.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax"]

_LAYER = re.compile(r"^(GCNConv|SAGEConv|GATConv)_(\d+)$")
_STATE = re.compile(r"^convs\.(\d+)\.(lin\.weight|bias|lin_l\.weight|lin_l\.bias|lin_r\.weight"
                    r"|att_src|att_dst)$")
# the flax params of a GATConv besides Dense_0, kept under the same names
_GAT_PARAMS = ("att_src", "att_dst", "bias")
# flax Dense module of each SAGEConv linear, and its torch name
_SAGE_DENSE = {"Dense_0": "lin_l", "Dense_1": "lin_r"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's `GCN`, `GraphSAGE` or `GAT` from the flax
    params, given as nested dicts of numpy arrays (with or without the
    outer "params" key)."""
    tree = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name, layer in tree.items():
        m = _LAYER.match(name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r}: only GCNConv, "
                             "SAGEConv and GATConv layers port")
        i = int(m.group(2))
        if m.group(1) == "GATConv":
            if set(layer) - {"Dense_0", *_GAT_PARAMS} or set(layer.get("Dense_0", {})) != {
                    "kernel"} or not {"att_src", "att_dst"} <= set(layer):
                raise ValueError(f"unexpected parameters in {name!r}: {sorted(layer)}")
            state[f"convs.{i}.lin.weight"] = _t(np.asarray(layer["Dense_0"]["kernel"]).T)
            for k in _GAT_PARAMS:
                if k in layer:
                    state[f"convs.{i}.{k}"] = _t(layer[k])
            continue
        if m.group(1) == "GCNConv":
            extra = set(layer) - {"Dense_0", "bias"}
            if extra or set(layer["Dense_0"]) != {"kernel"}:
                raise ValueError(f"unexpected parameters in {name!r}: {sorted(layer)}")
            state[f"convs.{i}.lin.weight"] = _t(np.asarray(layer["Dense_0"]["kernel"]).T)
            if "bias" in layer:
                state[f"convs.{i}.bias"] = _t(layer["bias"])
            continue
        if set(layer) - set(_SAGE_DENSE) or "Dense_0" not in layer:
            raise ValueError(f"unexpected parameters in {name!r}: {sorted(layer)}")
        for dense, lin in _SAGE_DENSE.items():
            if dense not in layer:
                continue
            allowed = {"kernel", "bias"} if dense == "Dense_0" else {"kernel"}
            if not {"kernel"} <= set(layer[dense]) <= allowed:
                raise ValueError(f"unexpected parameters in {name}/{dense}: "
                                 f"{sorted(layer[dense])}")
            state[f"convs.{i}.{lin}.weight"] = _t(np.asarray(layer[dense]["kernel"]).T)
            if "bias" in layer[dense]:
                state[f"convs.{i}.{lin}.bias"] = _t(layer[dense]["bias"])
    return state


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The flax params tree {"params": {"GCNConv_i": ...}},
    {"params": {"SAGEConv_i": ...}} or {"params": {"GATConv_i": ...}} of
    float32 numpy arrays, from the port's `GCN`, `GraphSAGE` or `GAT` state
    dict (a layer with attention vectors is a GATConv)."""
    tree: Dict[str, Dict] = {}
    matches = []
    for key in state:
        m = _STATE.match(key)
        if m is None:
            raise ValueError(f"unexpected parameter {key!r}: only GCNConv, SAGEConv and "
                             "GATConv layers port")
        matches.append(m)
    gat = {int(m.group(1)) for m in matches if m.group(2).startswith("att_")}
    for m, value in zip(matches, state.values()):
        i, what = int(m.group(1)), m.group(2)
        arr = value.detach().cpu().numpy().astype(np.float32)
        if what in ("lin.weight", "bias", "att_src", "att_dst"):
            layer = tree.setdefault(f"{'GATConv' if i in gat else 'GCNConv'}_{i}", {})
            if what != "lin.weight":
                layer[what] = arr.copy()
            else:
                layer["Dense_0"] = {"kernel": np.ascontiguousarray(arr.T)}
            continue
        lin, kind = what.split(".")
        dense = "Dense_0" if lin == "lin_l" else "Dense_1"
        entry = tree.setdefault(f"SAGEConv_{i}", {}).setdefault(dense, {})
        entry["kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(arr.T) if kind == "weight" else arr.copy())
    return {"params": tree}
