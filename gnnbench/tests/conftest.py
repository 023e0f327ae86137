"""Shared fixtures of the benchmark's CPU tests: a temporary checkout
holding BENCHMARK.json, the data files and small copies of the
configurations (`tiny-<config>`), and the card fixture of the `gpu` tests."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HERE = os.path.dirname(os.path.abspath(__file__))
# each configuration's file and a small graph of its generator, for the CPU:
# the cells' configurations, and a GCN no cell runs (its reference and
# stream route stay covered)
TINY = {
    "ogbn-arxiv-gat": (os.path.join(ROOT, "gnnbench", "configs", "ogbn-arxiv-gat.json"),
                       {"generator": "synthetic", "num_nodes": 300, "num_edges": 2000,
                        "power": 1.0, "seed": 0, "bidirect": True}),
    "gcn": (os.path.join(HERE, "configs", "gcn.json"),
            {"generator": "clustered", "num_nodes": 400, "num_edges": 4000, "mixing": 0.3,
             "mean_community": 50, "power": 1.0, "seed": 0}),
}


def make_checkout(tmp: str) -> str:
    """A checkout in `tmp` holding BENCHMARK.json and the data files, with a
    `tiny-<config>` copy of each configuration of `TINY` (its small graph,
    100 train nodes) and cells `tiny-<config>.train` and `.serve` (the
    first serve mix of BENCHMARK.json)."""
    os.makedirs(os.path.join(tmp, "gnnbench"), exist_ok=True)
    for d in ("configs", "traffic"):
        shutil.copytree(os.path.join(ROOT, "gnnbench", d), os.path.join(tmp, "gnnbench", d),
                        dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    serve = next(w["traffic"] for w in bench["workloads"] if w["traffic"] != "train")
    for name, (path, graph) in TINY.items():
        with open(path) as fh:
            cfg = json.load(fh)
        tiny = f"tiny-{name}"
        cfg.update(name=tiny, graph=graph, train_nodes=100)
        with open(os.path.join(tmp, "gnnbench", "configs", f"{tiny}.json"), "w") as fh:
            json.dump(cfg, fh)
        bench["configs"].append({"name": tiny, "source": "https://example.org/tiny",
                                 "file": f"gnnbench/configs/{tiny}.json", "reduced": [],
                                 "why": "a small copy for the CPU tests"})
        for t, mix in (("train", "train"), ("serve", serve)):
            bench["workloads"].append({"name": f"{tiny}.{t}", "config": tiny, "traffic": mix,
                                       "chips": 1, "why": "a small copy for the CPU tests"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return tmp


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(str(tmp_path))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
