"""Training loop, evaluation and checkpoints for node classification.

Port of `geot_tpu/models/train.py:34-203` (`cross_entropy_loss`,
`accuracy`, `make_train_step`, `train_node_classifier`, `save_checkpoint`,
`load_checkpoint`). optax's `adamw(lr, weight_decay=wd)` becomes
`torch.optim.AdamW` with the same decoupled update, betas and eps, in one
parameter group; the weight decay is passed explicitly (torch's default
differs from optax's).

Checkpoints keep the reference's file format, so a file written by either
package loads in the other: an `.npz` of `leaf_i` arrays in the order of
`jax.tree_util` (dict keys sorted), a `__paths__` JSON manifest of key
paths and a `__meta__` JSON object, both stored as bytes and read with
`allow_pickle=False`. The tree is the flax layout of the model's params
(`params_to_flax`, which carries every model of `MODELS`).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch.graph.structures import Graph
from geot_tpu_torch.models.weights import params_from_flax, params_to_flax
from geot_tpu_torch.utils.trace import setup_phase, span

__all__ = [
    "cross_entropy_loss",
    "accuracy",
    "make_optimizer",
    "make_train_step",
    "train_node_classifier",
    "save_checkpoint",
    "load_checkpoint",
]


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked mean softmax cross-entropy over the train split."""
    ls = torch.log_softmax(logits.float(), dim=-1)
    nll = -ls.gather(1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    m = mask.float()
    return ((pred == labels.long()).float() * m).sum() / torch.clamp(m.sum(), min=1.0)


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float):
    """optax.adamw(lr, weight_decay=weight_decay) with its defaults
    (b1 0.9, b2 0.999, eps 1e-8), over every parameter in one group. Its
    construction is the set-up phase "optimizer" (a process's first
    `torch.optim` constructor imports `torch._dynamo`)."""
    with setup_phase("optimizer"):
        return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)


def make_train_step(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, *, has_dropout: bool
) -> Callable:
    """Returns step(x, graph, y, mask, generator=None) -> loss: one
    forward, backward and optimizer update of `model` in place. With
    `has_dropout` the model runs in training mode and draws its dropout
    masks from `generator`; without, dropout is off (the reference's
    `deterministic=True`). The loss comes back detached, on the device.
    Under a profiler the step is the span "geot.train.step", and its
    phases "geot.train.zero_grad", ".forward", ".loss", ".backward" and
    ".optimizer"."""

    def step(x, graph: Graph, y, mask, generator: Optional[torch.Generator] = None):
        with span("geot.train.step"):
            model.train(has_dropout)
            with span("geot.train.zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            with span("geot.train.forward"):
                logits = model(x, graph, generator if has_dropout else None)
            with span("geot.train.loss"):
                loss = cross_entropy_loss(logits, y, mask)
            with span("geot.train.backward"):
                loss.backward()
            with span("geot.train.optimizer"):
                optimizer.step()
            return loss.detach()

    return step


@torch.no_grad()
def _eval(model, x, graph, y, masks) -> Tuple[torch.Tensor, ...]:
    was_training = model.training
    model.eval()
    logits = model(x, graph)
    model.train(was_training)
    return tuple(accuracy(logits, y, m) for m in masks)


def train_node_classifier(
    model: torch.nn.Module,
    graph: Graph,
    x: torch.Tensor,
    y: torch.Tensor,
    train_mask: torch.Tensor,
    val_mask: Optional[torch.Tensor] = None,
    test_mask: Optional[torch.Tensor] = None,
    *,
    epochs: int = 200,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    seed: int = 0,
    log_every: int = 0,
    checkpoint_path: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Full-graph training of an initialised `model` (its parameters come
    from the generator it was built with; `seed` seeds the dropout
    generator on the model's device). Keeps the parameters of the best
    validation accuracy when `val_mask` is given, loads them into
    `model`, and returns (state dict, metrics)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt = make_optimizer(model, lr, weight_decay)
    has_dropout = getattr(model, "dropout_rate", 0.0) > 0.0
    step = make_train_step(model, opt, has_dropout=has_dropout)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_val, best = -1.0, None
    masks = [train_mask] + [m for m in (val_mask, test_mask) if m is not None]
    loss = torch.zeros(())
    for epoch in range(epochs):
        loss = step(x, graph, y, train_mask, gen)
        if val_mask is not None and (epoch % 10 == 9 or epoch == epochs - 1):
            accs = _eval(model, x, graph, y, masks)
            if float(accs[1]) > best_val:
                best_val, best = float(accs[1]), snapshot()
            if log_every and epoch % log_every == log_every - 1:
                print(f"epoch {epoch + 1}: loss={float(loss):.4f} "
                      + " ".join(f"acc{i}={float(a):.4f}" for i, a in enumerate(accs)))
    if best is not None:
        model.load_state_dict(best)
    final = snapshot()
    accs = _eval(model, x, graph, y, masks)
    metrics = {"loss": float(loss), "train_acc": float(accs[0])}
    if val_mask is not None:
        metrics["val_acc"] = float(accs[1])
    if test_mask is not None:
        metrics["test_acc"] = float(accs[-1])
    if checkpoint_path:
        save_checkpoint(checkpoint_path, final, metrics)
    return final, metrics


def _flatten(tree, path=()):
    """(key path, leaf) pairs in `jax.tree_util` order (dict keys sorted);
    a path step is ["d", key]."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (["d", k],))
    else:
        yield list(path), tree


def save_checkpoint(path: str, state: Mapping[str, torch.Tensor],
                    metadata: Optional[dict] = None) -> None:
    """Pickle-free checkpoint of the state dict of any model of `MODELS`,
    as the flax params tree, in the reference's format (module docstring)."""
    flat = list(_flatten(params_to_flax(state)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        **{f"leaf_{i}": np.asarray(leaf) for i, (_, leaf) in enumerate(flat)},
        __paths__=np.frombuffer(json.dumps([p for p, _ in flat]).encode(), dtype=np.uint8),
        __meta__=np.frombuffer(json.dumps(metadata or {}).encode(), dtype=np.uint8),
    )


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state dict for the port's model, metadata) from a checkpoint
    written by this module or by the reference's `save_checkpoint`, of any
    model of `MODELS`. The tree is rebuilt from the manifest; their trees
    hold only dicts (the reference also writes list and attribute steps,
    which none of them has)."""
    d = np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False)
    manifest = json.loads(d["__paths__"].tobytes().decode())
    meta = json.loads(d["__meta__"].tobytes().decode())
    tree: dict = {}
    for i, steps in enumerate(manifest):
        if not steps or any(kind != "d" for kind, _ in steps):
            raise ValueError(f"checkpoint leaf {i} is not in a tree of dicts: {steps}")
        node = tree
        for _, key in steps[:-1]:
            node = node.setdefault(key, {})
        node[steps[-1][1]] = d[f"leaf_{i}"]
    return params_from_flax(tree), meta
