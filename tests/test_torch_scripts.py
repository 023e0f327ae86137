"""The port's training scripts against the reference's, and the entry points
that must not fall back to the CPU.

The reference's `scripts/train.py` and `scripts/train_dist.py` are loaded
from their files (never edited) and run in-process with `sys.argv`
patched; their printed rows and lines are parsed. On the `karate`
fixture, at hidden 16 and 2 layers:

- `train.py`, per model of `MODELS` (`--backend reference` on both
  sides): the reference script at `--epochs 0 --checkpoint` writes its
  initial parameters; the port's `main(["--device", "cpu", ...], model=...)`
  starts from them and trains 20 epochs beside the reference's 20-epoch
  run. The rows carry the same keys (the port's adds `device`); the final
  losses (the checkpoints' unrounded metadata) agree within 1e-3
  relative and each accuracy within one node of its mask; the port's
  checkpoint, read by the reference's `load_checkpoint`, holds the
  reference's tree with leaves within rtol 1e-3 / atol 1e-4 (20 AdamW
  steps in other summation orders).
- `--time-only` gives a positive `fwd_ms`, and `--csv` one header and a
  row a run.
- `train_dist.py` at `--parts 2` (the reference on two of conftest's
  virtual devices; the port on two spawned gloo ranks on the CPU) from the
  reference's `init_gcn_params(PRNGKey(0), dims)`: the losses at epochs
  10 and 20 within 1e-3 relative of the printed ones, the accuracies
  equal at the printed 4 decimals.

Without CUDA (`torch.cuda.is_available` patched to False) every repaired
entry point raises unless the CPU is named, and runs when it is.
"""

import ast
import contextlib
import csv
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from geot_tpu.models import train as jtrain
from geot_tpu.parallel.dist_train import init_gcn_params as jinit_gcn_params
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.models import MODELS, load_checkpoint, save_checkpoint
from geot_tpu_torch.parallel import (
    init_gcn_params,
    params_from_jax,
    partition_graph,
    shard_inputs,
)
from geot_tpu_torch.parallel.stream_partition import part_stream_plan
from geot_tpu_torch.scripts import train as ttrain
from geot_tpu_torch.scripts import train_dist as ttrain_dist
from geot_tpu_torch.utils.timing import timeit

ROOT = Path(__file__).resolve().parents[1]
DATA = ["--dataset", "karate", "--data-dir", str(ROOT / "tests" / "fixtures")]
SMALL = ["--hidden", "16", "--num-layers", "2"]
CPU = ["--device", "cpu"]
# the spawned ranks' limit in the distributed training script's runs
RANKS_TIMEOUT = ["--timeout", "240"]


def _run_reference(name: str, argv, monkeypatch) -> str:
    """The reference's `scripts/<name>.py` main() on `argv`: its stdout."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _row(stdout: str) -> dict:
    return ast.literal_eval(stdout.strip().splitlines()[-1])


def _meta(path) -> dict:
    return jtrain.load_checkpoint(str(path))[1]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_matches_the_reference_script(model, tmp_path, monkeypatch):
    args = DATA + SMALL + ["--model", model, "--backend", "reference"]
    init, jck, tck = (tmp_path / f"{k}.npz" for k in ("init", "reference", "port"))
    _run_reference("train", args + ["--epochs", "0", "--checkpoint", str(init)], monkeypatch)
    jrow = _row(_run_reference("train", args + ["--epochs", "20", "--checkpoint", str(jck)],
                               monkeypatch))
    row = ttrain.main(args + CPU + ["--epochs", "20", "--checkpoint", str(tck)],
                      model=load_checkpoint(str(init))[0])
    assert list(row) == list(jrow) + ["device"] and row["device"] == "cpu"
    assert {k: row[k] for k in jrow if not k.endswith(("loss", "_acc"))} == {
        k: v for k, v in jrow.items() if not k.endswith(("loss", "_acc"))}

    got, want = _meta(tck), _meta(jck)
    assert set(got) == set(want) == {"loss", "train_acc", "val_acc", "test_acc"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    fixture = np.load(ROOT / "tests" / "fixtures" / "karate.npz")
    for split in ("train", "val", "test"):
        one_node = 1.0 / int(fixture[f"{split}_mask"].sum())
        assert abs(got[f"{split}_acc"] - want[f"{split}_acc"]) <= one_node + 1e-9, split
        assert row[f"{split}_acc"] == round(got[f"{split}_acc"], 4)

    back, jparams = jtrain.load_checkpoint(str(tck))[0], jtrain.load_checkpoint(str(jck))[0]
    assert (jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams))
    for (path, a), (_, b) in zip(_leaves(back), _leaves(jparams)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_script_checkpoint_round_trips(model, tmp_path):
    """A model as `train` builds it (seeded), through `save_checkpoint`
    and `load_checkpoint` into a fresh model: the same state, bit for bit."""
    net = ttrain.build_model(model, 12, 8, 3, 5, seed=3, device="cpu")
    path = str(tmp_path / f"{model}.npz")
    save_checkpoint(path, net.state_dict(), {"model": model})
    state, meta = load_checkpoint(path)
    assert meta == {"model": model}
    fresh = ttrain.build_model(model, 12, 8, 3, 5, seed=4, device="cpu")
    fresh.load_state_dict(state)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_time_only_rows_and_csv(tmp_path, monkeypatch):
    args = DATA + SMALL + ["--time-only", "--iters", "2", "--backend", "reference"]
    jrow = _row(_run_reference("train", args, monkeypatch))
    path = tmp_path / "times.csv"
    rows = [ttrain.main(args + CPU + ["--csv", str(path)]) for _ in range(2)]
    for row in rows:
        assert list(row) == list(jrow) + ["device"]
        assert row["fwd_ms"] > 0
    lines = path.read_text().splitlines()
    assert len(lines) == 3 and lines[0] == ",".join(rows[0])
    assert [r["fwd_ms"] for r in csv.DictReader(io.StringIO(path.read_text()))] == [
        str(r["fwd_ms"]) for r in rows]


def test_train_dist_matches_the_reference_script(monkeypatch):
    args = DATA + SMALL + ["--parts", "2", "--epochs", "20"]
    printed = _run_reference("train_dist", args + ["--backend", "reference"], monkeypatch)
    losses = {int(e): float(v) for e, v in re.findall(r"epoch (\d+): loss=([\d.]+)", printed)}
    accs = {k: float(v) for k, v in re.findall(r"(\w+_acc): ([\d.]+)", printed)}
    assert sorted(losses) == [10, 20] and sorted(accs) == ["test_acc", "train_acc", "val_acc"]
    fixture = np.load(ROOT / "tests" / "fixtures" / "karate.npz")
    dims = [fixture["x"].shape[1], 16, int(fixture["y"].max()) + 1]
    params = params_from_jax(jinit_gcn_params(jax.random.PRNGKey(0), dims), "cpu")
    out = ttrain_dist.main(args + CPU + RANKS_TIMEOUT + ["--dist-backend", "gloo"],
                           params=params)
    assert out["parts"] == 2 and out["device"] == "cpu" and out["dist_backend"] == "gloo"
    assert sorted(out["losses"]) == [10, 20]
    for epoch, want in losses.items():
        np.testing.assert_allclose(out["losses"][epoch], want, rtol=1e-3)
    for k, want in accs.items():
        assert round(out[k], 4) == want, k
    assert out["epoch_ms"] > 0 and len(out["launches"]) == 2


def test_train_dist_refuses_nccl_without_cards(monkeypatch):
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        ttrain_dist.main(DATA + CPU + ["--dist-backend", "nccl", "--parts", "1"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        ttrain_dist.main(DATA + ["--dist-backend", "nccl", "--parts", "2"])


_RNG = np.random.default_rng(5)
SRC = _RNG.integers(0, 60, 400).astype(np.int32)
DST = np.sort(_RNG.integers(0, 60, 400)).astype(np.int32)


def _flag(device):
    return [] if device is None else ["--device", device]


@functools.lru_cache(maxsize=None)
def _stream_family():
    """The interior stream family of a 2-part hybrid partition of
    part-aligned communities (the census streams them)."""
    rng = np.random.default_rng(41)
    part = rng.integers(0, 2, 12_000)
    src = (part * 256 + rng.integers(0, 256, 12_000)).astype(np.int32)
    dst = (part * 256 + rng.integers(0, 256, 12_000)).astype(np.int32)
    pg = partition_graph(src, dst, 512, 2, s_tile=32, layout="hybrid", bat_e_tile=256,
                         max_chunk_tiles=8)
    assert pg.stream_int is not None
    return pg.stream_int


# each called with device=None (the default) and with "cpu"
ENTRY_POINTS = {
    "build_bat_plan": lambda dev: tplan.build_bat_plan(DST, 60, e_tile=32, s_tile=32,
                                                       device=dev),
    "build_segment_plan": lambda dev: tplan.build_segment_plan(DST, SRC, 60, e_tile=32,
                                                               s_tile=32, device=dev),
    "build_bucketed_bat_plan": lambda dev: tplan.build_bucketed_bat_plan(
        SRC, DST, 60, 60, e_tile=32, s_tile=32, bucket_rows=32, device=dev),
    "PartitionedGraph.part": lambda dev: partition_graph(SRC, DST, 60, 2).part(0, dev),
    "PartBatFamily.unbatch": lambda dev: partition_graph(SRC, DST, 60, 2,
                                                         layout="bat").bat.unbatch(0, dev),
    "part_stream_plan": lambda dev: part_stream_plan(_stream_family(), 0, dev),
    "init_gcn_params": lambda dev: init_gcn_params(
        [8, 4], generator=torch.Generator().manual_seed(0), device=dev),
    "params_from_jax": lambda dev: params_from_jax({"w0": np.ones((8, 4), np.float32)}, dev),
    "shard_inputs": lambda dev: shard_inputs(
        np.ones((60, 8), np.float32), np.zeros(60, np.int64), np.ones(60, bool),
        partition_graph(SRC, DST, 60, 2), 0, dev),
    "timeit": lambda dev: timeit(lambda: None, warmup=1, iters=2, device=dev),
    "train.main": lambda dev: ttrain.main(DATA + SMALL + ["--epochs", "1"] + _flag(dev)),
    "train_dist.main": lambda dev: ttrain_dist.main(
        DATA + SMALL + RANKS_TIMEOUT + ["--epochs", "1", "--parts", "2", "--dist-backend",
                                        "gloo"] + _flag(dev)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_the_card_or_the_cpu_named(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](None)
    ENTRY_POINTS[name]("cpu")
