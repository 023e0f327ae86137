"""The command refuses, with no result line, where it cannot measure: no
card, or a checkout that holds only the benchmark. On a card, the small
cells run whole and come out correct."""

import os
import shutil
import subprocess
import sys
import time

import pytest

from gnnbench.tests.conftest import ROOT


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "gnnbench/run.py", "--workload", "arxiv-gat.serve",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gnnbench"), tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny-gcn.train", "tiny-gcn.serve",
                                  "tiny-ogbn-arxiv-gat.train", "tiny-ogbn-arxiv-gat.serve"])
def test_small_cells_on_the_card(checkout, card, cell):
    from gnnbench.harness.cell import run_cell
    from gnnbench.harness.manifest import load_cell

    r = run_cell(load_cell(checkout, cell), 2**31 + 7, 0.5, True, card, time.perf_counter(), None)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["metrics"]
