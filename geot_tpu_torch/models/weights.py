"""Carry the parameters of every model in `MODELS` between the reference's
flax layout and the port.

A flax `Dense` kernel [in, out] is the port's `nn.Linear` weight [out, in]
transposed; biases and the other leaves keep their shapes. Per flax
module of the reference, the port's state-dict keys are:

    GCNConv_{i}/Dense_0/kernel, bias         convs.{i}.lin.weight, convs.{i}.bias
    SAGEConv_{i}/Dense_0/{kernel, bias}      convs.{i}.lin_l.{weight, bias}
    SAGEConv_{i}/Dense_1/kernel              convs.{i}.lin_r.weight
    GATConv_{i}/Dense_0/kernel               convs.{i}.lin.weight
    GATConv_{i}/{att_src, att_dst, bias}     convs.{i}.{att_src, att_dst, bias}
    GINConv_{i}/MLP_0/Dense_{j}/{kernel, bias}
                                             convs.{i}.mlp.lins.{j}.{weight, bias}
    GINConv_{i}/eps (train_eps)              convs.{i}.eps
    SGConv_{i}/Dense_0/{kernel, bias}        convs.{i}.dense.{weight, bias}
    Dense_{i}/{kernel, bias} (APPNP's MLP)   lins.{i}.{weight, bias}
    Dense_0/{kernel, bias} (BasicGNN's jk head)
                                             head.{weight, bias}
    LayerNorm_{i}/{scale, bias}              norms.{i}.{weight, bias}
    BatchNorm_{i}/{scale, bias}              norms.{i}.{weight, bias}
    batch_stats BatchNorm_{i}/{mean, var}    norms.{i}.{running_mean, running_var}

APPNP's `APPNPConv_0` has no parameters (flax leaves it out of the tree).
A top-level `Dense_0` is BasicGNN's jk head where the tree holds conv
layers, else APPNP's MLP. A port layer with attention vectors is a
GATConv, else a `lin` layer is a GCNConv; a norm with running averages is
a BatchNorm. `params_from_flax` and `params_to_flax` are inverses.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax"]

_MODULE = re.compile(r"^(GCNConv|SAGEConv|GATConv|GINConv|SGConv|Dense|APPNPConv|LayerNorm"
                     r"|BatchNorm)_(\d+)$")
_CONVS = ("GCNConv", "SAGEConv", "GATConv", "GINConv", "SGConv")
_DENSE = re.compile(r"^Dense_(\d+)$")
_KB = {"kernel", "bias"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense_leaves(name: str, dense: Mapping, prefix: str, allowed=_KB,
                  required=("kernel",)) -> Dict[str, torch.Tensor]:
    """`prefix`.weight (the kernel transposed) and `prefix`.bias of one
    flax Dense, after checking its leaves."""
    if not set(required) <= set(dense) <= set(allowed):
        raise ValueError(f"unexpected parameters in {name}: {sorted(dense)}")
    out = {f"{prefix}.weight": _t(np.asarray(dense["kernel"]).T)}
    if "bias" in dense:
        out[f"{prefix}.bias"] = _t(dense["bias"])
    return out


def _check_keys(name: str, layer: Mapping, allowed, required=()) -> None:
    if not set(required) <= set(layer) <= set(allowed):
        raise ValueError(f"unexpected parameters in {name!r}: {sorted(layer)}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's model from the flax variables of the same
    model in the reference, given as nested dicts of numpy arrays (with or
    without the outer "params" key; BatchNorm's running averages under
    "batch_stats")."""
    tree = params.get("params", params)
    stats = params.get("batch_stats", {}) if "params" in params else {}
    state: Dict[str, torch.Tensor] = {}
    has_convs = any(_MODULE.match(k) and _MODULE.match(k).group(1) in _CONVS for k in tree)
    for name, layer in tree.items():
        m = _MODULE.match(name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r}: only the layers of the "
                             "models in MODELS port")
        kind, i = m.group(1), int(m.group(2))
        c = f"convs.{i}"
        if kind == "GCNConv":
            _check_keys(name, layer, {"Dense_0", "bias"}, ("Dense_0",))
            state.update(_dense_leaves(f"{name}/Dense_0", layer["Dense_0"], f"{c}.lin",
                                       allowed={"kernel"}))
            if "bias" in layer:
                state[f"{c}.bias"] = _t(layer["bias"])
        elif kind == "GATConv":
            _check_keys(name, layer, {"Dense_0", "att_src", "att_dst", "bias"},
                        ("Dense_0", "att_src", "att_dst"))
            state.update(_dense_leaves(f"{name}/Dense_0", layer["Dense_0"], f"{c}.lin",
                                       allowed={"kernel"}))
            for k in ("att_src", "att_dst", "bias"):
                if k in layer:
                    state[f"{c}.{k}"] = _t(layer[k])
        elif kind == "SAGEConv":
            _check_keys(name, layer, {"Dense_0", "Dense_1"}, ("Dense_0",))
            state.update(_dense_leaves(f"{name}/Dense_0", layer["Dense_0"], f"{c}.lin_l"))
            if "Dense_1" in layer:
                state.update(_dense_leaves(f"{name}/Dense_1", layer["Dense_1"],
                                           f"{c}.lin_r", allowed={"kernel"}))
        elif kind == "GINConv":
            _check_keys(name, layer, {"MLP_0", "eps"}, ("MLP_0",))
            for dname, dense in layer["MLP_0"].items():
                d = _DENSE.match(dname)
                if d is None:
                    raise ValueError(f"unexpected module {name}/MLP_0/{dname}")
                state.update(_dense_leaves(f"{name}/MLP_0/{dname}", dense,
                                           f"{c}.mlp.lins.{int(d.group(1))}", required=_KB))
            if "eps" in layer:
                state[f"{c}.eps"] = _t(layer["eps"])
        elif kind == "SGConv":
            _check_keys(name, layer, {"Dense_0"}, ("Dense_0",))
            state.update(_dense_leaves(f"{name}/Dense_0", layer["Dense_0"], f"{c}.dense"))
        elif kind == "Dense" and has_convs:  # BasicGNN's jk head
            state.update(_dense_leaves(name, layer, "head", required=_KB))
        elif kind == "Dense":  # APPNP's MLP: every Dense has its bias
            state.update(_dense_leaves(name, layer, f"lins.{i}", required=_KB))
        elif kind in ("LayerNorm", "BatchNorm"):
            _check_keys(name, layer, {"scale", "bias"}, ("scale", "bias"))
            state[f"norms.{i}.weight"] = _t(layer["scale"])
            state[f"norms.{i}.bias"] = _t(layer["bias"])
            if kind == "BatchNorm":
                bs = stats.get(name)
                if bs is None:
                    raise ValueError(f"{name!r} has no batch_stats (pass the whole variables)")
                _check_keys(f"batch_stats/{name}", bs, {"mean", "var"}, ("mean", "var"))
                state[f"norms.{i}.running_mean"] = _t(bs["mean"])
                state[f"norms.{i}.running_var"] = _t(bs["var"])
        elif layer:  # APPNPConv
            raise ValueError(f"{name!r} has no parameters, got {sorted(layer)}")
    return state


# the port's key -> (flax path, leaf is a transposed kernel); GCN or GAT
# `lin` layers are told apart by their attention vectors, Layer and
# BatchNorms by their running averages
_KEY = re.compile(r"^(?:convs\.(\d+)\.(lin\.weight|bias|att_src|att_dst|lin_l\.weight"
                  r"|lin_l\.bias|lin_r\.weight|eps|dense\.weight|dense\.bias"
                  r"|mlp\.lins\.(\d+)\.(?:weight|bias))|lins\.(\d+)\.(weight|bias)"
                  r"|norms\.(\d+)\.(weight|bias|running_mean|running_var)"
                  r"|head\.(weight|bias))$")
_NORM_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _flax_path(key: str, m: re.Match, gat: set, bn: set) -> Tuple[Tuple[str, ...], bool]:
    if m.group(8) is not None:  # BasicGNN's jk head
        leaf = m.group(8)
        return ("Dense_0", "kernel" if leaf == "weight" else "bias"), leaf == "weight"
    if m.group(6) is not None:  # norms.{i}
        i, leaf = int(m.group(6)), m.group(7)
        layer = f"{'BatchNorm' if i in bn else 'LayerNorm'}_{i}"
        if leaf.startswith("running_"):
            return ("batch_stats", layer, _NORM_LEAF[leaf]), False
        return (layer, _NORM_LEAF[leaf]), False
    if m.group(4) is not None:  # APPNP's lins.{i}
        leaf = m.group(5)
        return (f"Dense_{m.group(4)}", "kernel" if leaf == "weight" else "bias"), \
            leaf == "weight"
    i, what = int(m.group(1)), m.group(2)
    kernel = what.endswith("weight")
    leaf = "kernel" if kernel else "bias"
    if what.startswith("mlp."):
        return (f"GINConv_{i}", "MLP_0", f"Dense_{m.group(3)}", leaf), kernel
    if what == "eps":
        return (f"GINConv_{i}", "eps"), False
    if what.startswith("dense."):
        return (f"SGConv_{i}", "Dense_0", leaf), kernel
    if what.startswith("lin_"):
        return (f"SAGEConv_{i}", "Dense_0" if what.startswith("lin_l") else "Dense_1",
                leaf), kernel
    layer = f"{'GATConv' if i in gat else 'GCNConv'}_{i}"
    return ((layer, "Dense_0", "kernel") if what == "lin.weight" else (layer, what)), kernel


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The flax variables {"params": {...}} (and "batch_stats" where the
    model has BatchNorms) of float32 numpy arrays of the reference's
    model, from the port's state dict of the same model."""
    matches = []
    for key in state:
        m = _KEY.match(key)
        if m is None:
            raise ValueError(f"unexpected parameter {key!r}: only the layers of the models "
                             "in MODELS port")
        matches.append(m)
    gat = {int(m.group(1)) for m in matches
           if m.group(2) is not None and m.group(2).startswith("att_")}
    bn = {int(m.group(6)) for m in matches
          if m.group(7) is not None and m.group(7).startswith("running_")}
    tree: Dict[str, Dict] = {}
    stats: Dict[str, Dict] = {}
    for (key, value), m in zip(state.items(), matches):
        path, kernel = _flax_path(key, m, gat, bn)
        node = tree
        if path[0] == "batch_stats":
            node, path = stats, path[1:]
        arr = value.detach().cpu().numpy().astype(np.float32)
        for step in path[:-1]:
            node = node.setdefault(step, {})
        node[path[-1]] = np.ascontiguousarray(arr.T) if kernel else arr.copy()
    return {"params": tree, "batch_stats": stats} if stats else {"params": tree}
