"""A whole run of the harness on the CPU (the look for a card skipped) at
each configuration's small copy, with the timed path broken underneath,
must come out not correct; so must the control, the reference in TF32 put
in the program's place. The limits are the configurations' own."""

import time

import pytest
import torch

import geot_tpu_torch.models.train as program_train
from gnnbench.control import readings
from gnnbench.harness import correct as cmp
from gnnbench.harness import system
from gnnbench.harness.cell import run_cell
from gnnbench.harness.manifest import load_cell

CONFIGS = ["tiny-gcn", "tiny-ogbn-arxiv-gat"]
SEED = 2**31 + 101


def _run(checkout, cell):
    return run_cell(load_cell(checkout, cell), SEED, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), None)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("loop", ["train", "serve"])
def test_an_unbroken_run_is_correct(checkout, config, loop):
    r = _run(checkout, f"{config}.{loop}")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("config", CONFIGS)
def test_a_step_that_leaves_the_state_unchanged(checkout, config, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    r = _run(checkout, f"{config}.train")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.5  # no leaf moved


@pytest.mark.parametrize("config", CONFIGS)
def test_half_the_batch_left_out(checkout, config, monkeypatch):
    full = program_train.cross_entropy_loss

    def half(logits, labels, mask):
        rows = mask.nonzero()[:, 0]
        m = mask.clone()
        m[rows[rows.numel() // 2:]] = False
        return full(logits, labels, m)

    monkeypatch.setattr(program_train, "cross_entropy_loss", half)
    r = _run(checkout, f"{config}.train")
    assert not r["correct"]


@pytest.mark.parametrize("config", CONFIGS)
def test_an_answer_altered_where_it_is_produced(checkout, config, monkeypatch):
    build = system.build_model

    def altered_build(cfg, device):
        model = build(cfg, device)
        forward = model.forward

        def altered(*a, **kw):
            out = forward(*a, **kw).clone()
            out[7] = out[7].flip(0)
            return out

        model.forward = altered
        return model

    monkeypatch.setattr(system, "build_model", altered_build)
    r = _run(checkout, f"{config}.serve")
    assert not r["correct"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("loop", ["train", "serve"])
def test_the_control_and_the_faults_fail_the_limits(checkout, config, loop):
    cell = load_cell(checkout, f"{config}.{loop}")
    rows = []
    readings(cell, [SEED], {SEED}, torch.device("cpu"), None, rows.append)
    limits = cell.config["limits"][loop]
    by_side = {r["side"]: r for r in rows}
    assert cmp.verdict({k: by_side["program"][k] for k in limits}, limits)[0]
    for side, r in by_side.items():
        if side != "program":
            ok, checks = cmp.verdict({k: r[k] for k in limits}, limits)
            assert not ok, (side, checks)
