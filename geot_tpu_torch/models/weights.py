"""Carry GCN parameters between the reference's flax layout and the port.

The flax tree of `geot_tpu.models.GCN` holds, for layer i,
`GCNConv_{i}/Dense_0/kernel` [in, out] and `GCNConv_{i}/bias` [out].
The port's `GCN` keeps them as `convs.{i}.lin.weight` [out, in] (the
kernel transposed) and `convs.{i}.bias`. `params_from_flax` and
`params_to_flax` are inverses.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax"]

_LAYER = re.compile(r"^GCNConv_(\d+)$")
_STATE = re.compile(r"^convs\.(\d+)\.(lin\.weight|bias)$")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's `GCN` from the flax params, given as nested
    dicts of numpy arrays (with or without the outer "params" key)."""
    tree = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name, layer in tree.items():
        m = _LAYER.match(name)
        if m is None:
            raise ValueError(f"unexpected flax module {name!r}: only GCNConv layers port")
        extra = set(layer) - {"Dense_0", "bias"}
        if extra or set(layer["Dense_0"]) != {"kernel"}:
            raise ValueError(f"unexpected parameters in {name!r}: {sorted(layer)}")
        i = int(m.group(1))
        kernel = np.asarray(layer["Dense_0"]["kernel"], np.float32)
        state[f"convs.{i}.lin.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        if "bias" in layer:
            state[f"convs.{i}.bias"] = torch.from_numpy(
                np.asarray(layer["bias"], np.float32).copy()
            )
    return state


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The flax params tree {"params": {"GCNConv_i": {"Dense_0": {"kernel"},
    "bias"}}} of float32 numpy arrays, from the port's `GCN` state dict."""
    tree: Dict[str, Dict] = {}
    for key, value in state.items():
        m = _STATE.match(key)
        if m is None:
            raise ValueError(f"unexpected parameter {key!r}: only GCNConv layers port")
        layer = tree.setdefault(f"GCNConv_{int(m.group(1))}", {})
        arr = value.detach().cpu().numpy().astype(np.float32)
        if m.group(2) == "bias":
            layer["bias"] = arr.copy()
        else:
            layer["Dense_0"] = {"kernel": np.ascontiguousarray(arr.T)}
    return {"params": tree}
