"""BENCHMARK.json keeps to its contract, and cells, configurations, mixes
and metric readers are found by name: a configuration dropped into a
copy of the checkout is found without an edit."""

import importlib
import json
import os
import re

import pytest

from gnnbench.harness.manifest import load_cell, metric_reader, metrics_of
from gnnbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "gnnbench/run.py"] and bench["paths"] == ["gnnbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = bench["workloads"]
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("gnnbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in cells)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = load_cell(ROOT, w["name"])
        names = {m["name"] for m in metrics_of(cell, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        per_layer = metrics_of(cell, "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in names and m["moves"] in e2e
            assert callable(metric_reader(m["name"]))
        assert importlib.import_module(f"gnnbench.reference.{cell.config['reference']['module']}")


def test_a_dropped_configuration_is_found(checkout):
    bench_path = os.path.join(checkout, "BENCHMARK.json")
    with open(os.path.join(checkout, "gnnbench", "configs", "ogbn-arxiv-gat.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "new-model"
    with open(os.path.join(checkout, "gnnbench", "configs", "new-model.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(checkout, "gnnbench", "traffic", "burst.json"), "w") as fh:
        json.dump({"loop": "serve", "rate_per_s": 5, "warmup_requests": 1, "sampled_requests": 1,
                   "trace_seconds": 1, "trace_min_iters": 1, "trace_max_iters": 2}, fh)
    with open(bench_path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "new-model", "source": "https://example.org",
                             "file": "gnnbench/configs/new-model.json", "reduced": [],
                             "why": "dropped in"})
    bench["workloads"].append({"name": "new-model.burst", "config": "new-model",
                               "traffic": "burst", "chips": 1, "why": "dropped in"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_p95_ms", "launches.serve"):
            m["workloads"].append("new-model.burst")
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)
    cell = load_cell(checkout, "new-model.burst")
    assert cell.config["name"] == "new-model" and cell.loop == "serve" and cell.chips == 1
    assert "serve_p95_ms" in {m["name"] for m in metrics_of(cell, "end_to_end")}
    assert [m["name"] for m in metrics_of(cell, "per_layer")] == ["plan_build_s",
                                                                  "launches.serve"]
    with pytest.raises(KeyError):
        load_cell(checkout, "no-such.cell")

