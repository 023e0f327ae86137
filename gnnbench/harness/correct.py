"""The numbers that decide `correct`, from the program's outputs and the
plain reference's, and the verdict against the configuration's limits.

Training (the first three steps of the object the window then drives):
  loss_gap    the largest |loss - reference loss| / |reference loss| of
              the three steps;
  grad_gap    the gap between the norm of a leaf's first gradient in the
              program (its optimizer's first moment after one step, over
              1 - beta1) and in the reference, against the larger of that
              leaf's reference norm and the median leaf's, of the worst
              leaf;
  change_gap  the same for each leaf's change over the three steps, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's (below that a leaf moves under Adam by
              round-off alone), of the worst of them.
Serving (requests of the window):
  logit_err   the largest |logit - reference logit| of the window's last
              request, against the largest |reference logit|;
  class_gap   over the sampled requests' served classes, the widest gap
              by which a served class's reference logit lies below the
              reference's best, against the largest |reference logit|.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["train_numbers", "leaf_gaps", "serve_numbers", "verdict", "LEAF_FLOOR"]

LEAF_FLOOR = 1e-3


def _median(values: List[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def _worst(values: List[float]) -> float:
    """The largest value; infinite where any is not finite (a NaN would
    slip past `max`)."""
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _gap(prog: float, ref: float, med: float) -> float:
    """|prog - ref| over the larger of ref and the median leaf's norm."""
    den = max(ref, med)
    return abs(prog - ref) / den if den > 0 else abs(prog - ref)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog / ref: {"losses": [3 floats], "grad": {leaf: tensor},
    "change": {leaf: tensor}}."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if any(not math.isfinite(v) for v in prog["losses"]):
        loss_gap = math.inf
    g_prog = {k: float(v.double().norm()) for k, v in prog["grad"].items()}
    g_ref = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    c_prog = {k: float(v.double().norm()) for k, v in prog["change"].items()}
    c_ref = {k: float(v.double().norm()) for k, v in ref["change"].items()}
    g_med = _median(list(g_ref.values()))
    moving = [k for k in c_ref if g_ref[k] >= LEAF_FLOOR * g_med]
    c_med = _median([c_ref[k] for k in moving])
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst([_gap(g_prog[k], g_ref[k], g_med) for k in g_ref]),
        "change_gap": _worst([_gap(c_prog[k], c_ref[k], c_med) for k in moving]),
    }


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gradient and change gap as `train_numbers` weighs them."""
    out = {}
    for part in ("grad", "change"):
        p = {k: float(v.double().norm()) for k, v in prog[part].items()}
        r = {k: float(v.double().norm()) for k, v in ref[part].items()}
        med = _median(list(r.values()))
        out[part] = {k: _gap(p[k], r[k], med) for k in r}
    return out


def serve_numbers(last_logits: torch.Tensor, served: List[torch.Tensor],
                  ref_logits: torch.Tensor) -> Dict[str, float]:
    scale = float(ref_logits.abs().max())
    err = float((last_logits.float() - ref_logits).abs().max()) / scale
    best = ref_logits.max(dim=1).values
    gap = 0.0
    for pred in served:
        got = ref_logits.gather(1, pred.to(ref_logits.device).long()[:, None])[:, 0]
        gap = max(gap, float((best - got).max()) / scale)
    if not math.isfinite(err):
        err = math.inf
    return {"logit_err": err, "class_gap": gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number has
    a limit and stays at or under it."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
