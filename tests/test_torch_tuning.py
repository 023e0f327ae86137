"""The port's tuning layer against the JAX package's, on the CPU.

Mirrors tests/test_tuning.py. One temporary table file is read by both
packages (each through its own variable: GEOT_TPU_TUNING_TABLE,
GEOT_TORCH_TUNING_TABLE): exact keys and nearest-bucket keys give the same
configuration and source in both, the 20 M-edge clamp of slot modes
included. Where the reference answers without a measurement (its latency
floor below 12,000 edges, its analytic heuristic) the port answers
`build_graph`'s default knobs instead: those answers are TPU facts. An
empty table gives today's knobs, and the graphs built with the knobs left
to it are bit-identical to those built with the knobs given.
`measure_config(device="cpu")` and `sweep_graph` run the plain versions;
a configuration that applies but fails or disagrees with the plain route
raises, and the sweep's entry point needs its --out.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import geot_tpu.tuning.heuristics as jheur
import geot_tpu.tuning.sweep as jsweep
from geot_tpu.tuning.augment import augment_sorted_index as jaugment
from geot_tpu_torch.graph.structures import DEFAULT_KNOBS, build_graph
from geot_tpu_torch.models import prepare_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.tuning import augment as taugment
from geot_tpu_torch.tuning import heuristics as theur
from geot_tpu_torch.tuning import report as treport
from geot_tpu_torch.tuning import sweep as tsweep

SHIPPED = os.path.join(os.path.dirname(theur.__file__), "table.json")


@pytest.fixture
def table(tmp_path, monkeypatch):
    """Point both packages at one table file; returns a writer."""
    path = str(tmp_path / "table.json")

    def write(results):
        if os.path.exists(path):
            os.remove(path)
        tsweep.write_table(results, path)
        monkeypatch.setenv(jheur.TABLE_ENV, path)
        monkeypatch.setenv(theur.TABLE_ENV, path)
        jheur._table_cache = None
        return path

    yield write
    jheur._table_cache = None


def _cfg(mode, e=256, s=128, f=128):
    return theur.KernelConfig(mode, e, s, f), 1.0


def test_write_table_same_file_both_packages(tmp_path):
    res_t = {"spmm:7:20:3": _cfg("bat", 1024, 256), "spmm_dyn:5:20:3": _cfg("sr", 512, 256),
             "spmm_hyb:7:20:3": _cfg("hybrid")}
    res_j = {k: (jheur.KernelConfig(**dataclasses.asdict(c)), t) for k, (c, t) in res_t.items()}
    pt, pj = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    for p in (pt, pj):
        with open(p, "w") as f:
            json.dump({"index_scatter:1:2:3": {"mode": "xla", "e_tile": 256, "s_tile": 128,
                                                "f_tile": 128}}, f)
    tsweep.write_table(res_t, pt)
    jsweep.write_table(res_j, pj)
    assert open(pt).read() == open(pj).read()
    assert len(json.load(open(pt))) == 4


SHAPES = [
    (64, 500_000, 50_000), (128, 500_000, 50_000), (64, 2_000_000, 80_000),
    (40, 1_166_243, 169_343), (128, 1_166_243, 169_343), (8, 30_000, 2_000),
    (500, 899_756, 89_250), (128, 61_859_140, 2_449_029), (32, 25_000_000, 1_000_000),
    (128, 13_000, 3_000), (32, 60_000_000, 2_000_000),
]


def test_select_config_equals_reference(table):
    """Exact and nearest-bucket answers equal the reference's on one file,
    with the clamp of a slot winner to BAT past 20 M edges."""
    kb = theur.bucket_key
    table({
        f"spmm:{kb(64, 500_000, 50_000)}": _cfg("bat", 1024, 256),
        f"spmm:{kb(500, 899_756, 89_250)}": _cfg("sr", 512, 256),
        f"spmm:{kb(32, 30_000_000, 1_000_000)}": _cfg("packed", 512, 256),
        f"spmm_dyn:{kb(40, 1_166_243, 169_343)}": _cfg("bat_packed", 512, 256),
        f"index_scatter:{kb(64, 500_000, 50_000)}": _cfg("bat", 512, 128),
        f"index_scatter:{kb(8, 30_000, 2_000)}": _cfg("xla"),
    })
    seen = set()
    for op in ("spmm", "spmm_dyn", "index_scatter"):
        for f, nnz, n in SHAPES:
            j_cfg, j_src = jheur.select_config_ex(f, nnz, n, op=op)
            t_cfg, t_src = theur.select_config_ex(f, nnz, n, op=op)
            assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg), (op, f, nnz)
            assert t_src == j_src, (op, f, nnz)
            assert theur.select_config(f, nnz, n, op=op) == t_cfg
            seen.add(t_src)
    assert seen == {"table", "near"}
    # the clamp: a slot winner interpolated past 20 M edges builds BAT
    cfg, src = theur.select_config_ex(32, 60_000_000, 2_000_000, op="spmm")
    assert (cfg.mode, cfg.e_tile, src) == ("bat", 512, "near")


def test_no_measurement_gives_the_default_not_the_tpu_rules(table):
    """A family without keys, and any shape under an empty table, answer
    DEFAULT_CONFIG ("default") where the reference answers its TPU floor
    ("xla" below 12,000 edges) or its heuristic."""
    table({"spmm:7:20:3": _cfg("sr", 512, 256)})
    for f, nnz, n in [(128, 10_000, 9_000), (8, 100_000, 10_000), (128, 1_000_000, 10_000)]:
        assert theur.select_config_ex(f, nnz, n, op="spmm_dyn") == (theur.DEFAULT_CONFIG,
                                                                    "default")
        assert jheur.select_config_ex(f, nnz, n, op="spmm_dyn")[1] in ("floor", "heuristic")
    assert theur.select_config(128, 10_000, 9_000).mode == "sr"  # no floor in the port
    assert jheur.select_config(128, 10_000, 9_000).mode == "xla"
    table({})
    assert theur.load_table() == {}
    assert theur.select_config_ex(64, 500_000, 50_000) == (theur.DEFAULT_CONFIG, "default")
    assert (theur.DEFAULT_CONFIG.e_tile, theur.DEFAULT_CONFIG.s_tile) == (
        DEFAULT_KNOBS["bat_e_tile"], DEFAULT_KNOBS["bat_s_tile"])


def _edges(n=900, e=9000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
            rng.random(e).astype(np.float32), n)


def _assert_same_graph(a, b, name="graph"):
    """Every tensor and static equal (host seconds and build_stats aside)."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), name
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), name
        for f in dataclasses.fields(a):
            if f.name not in ("build_stats", "seconds"):
                _assert_same_graph(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_graph(x, y, f"{name}.{i}")
    else:
        assert a == b, name


@pytest.mark.parametrize("feature_hint", [128, 40])
@pytest.mark.parametrize("empty", ["shipped", "file"])
def test_empty_table_gives_todays_knobs(table, monkeypatch, feature_hint, empty):
    """The shipped table is empty; with it (or any empty table) the knobs
    left unset resolve to DEFAULT_KNOBS, and every plan is bit-identical
    to the build with those knobs given. A small graph (below the
    reference's 12,000-edge floor) keeps the BAT preference."""
    with open(SHIPPED) as f:
        assert json.load(f) == {}
    if empty == "shipped":
        monkeypatch.delenv(theur.TABLE_ENV, raising=False)
    else:
        table({})
    assert theur.load_table() == {}
    src, dst, w, n = _edges()
    kw = dict(edge_weight=w, feature_hint=feature_hint, layouts=("bat", "slot", "stream"),
              device="cpu")
    g_table = build_graph(src, dst, n, **kw)
    g_given = build_graph(src, dst, n, **DEFAULT_KNOBS, **kw)
    _assert_same_graph(g_table, g_given)
    assert g_table.bat.e_tile == 1024 and g_table.plan.e_tile == 512
    assert g_table.bat.km_pack == (2 if feature_hint == 40 else 0)
    assert (g_table.prefer, g_table.prefer_dyn) == ("bat", "bat")
    if feature_hint == 128:
        assert g_table.build_stats["stream_decided_by"] == "census"
    p_table = prepare_graph(src, dst, n, feature_hint=feature_hint, device="cpu")
    p_given = prepare_graph(src, dst, n, feature_hint=feature_hint, device="cpu",
                            **DEFAULT_KNOBS)
    _assert_same_graph(p_table, p_given)


def test_measured_table_sets_the_knobs(table, monkeypatch):
    """A measured pick builds its knobs: slot tiles and mode hint from the
    slot pick, BAT tiles from the BAT pick, the preferences from each op;
    a measured "bat" winner unpacks narrow BAT plans; "xla" takes the plain
    route; a hybrid verdict vetoes or endorses the census."""
    src, dst, w, n = _edges()
    kb = theur.bucket_key(40, len(src), n)
    table({f"spmm:{kb}": _cfg("sr", 256, 128), f"spmm_dyn:{kb}": _cfg("bat", 512, 128)})
    g = build_graph(src, dst, n, edge_weight=w, feature_hint=40, device="cpu")
    assert (g.plan.e_tile, g.plan.s_tile, g.plan.mode_hint) == (256, 128, "sr")
    assert (g.bat.e_tile, g.bat.s_tile, g.bat.km_pack) == (512, 128, 0)
    assert (g.prefer, g.prefer_dyn) == ("sr", "bat")
    assert tapi.dispatch_path(g) == "slot_static" and tapi.dispatch_path(
        g, dynamic_w=True) == "bat_dyn"
    # given knobs win over the table
    g2 = build_graph(src, dst, n, edge_weight=w, feature_hint=40, e_tile=64, prefer="bat",
                     device="cpu")
    assert g2.plan.e_tile == 64 and g2.prefer == "bat" and g2.plan.s_tile == 128

    table({f"spmm:{kb}": _cfg("xla"), f"spmm_dyn:{kb}": _cfg("xla"),
           f"index_scatter:{theur.bucket_key(40, len(src), n)}": _cfg("xla")})
    g = build_graph(src, dst, n, edge_weight=w, feature_hint=40, device="cpu")
    assert tapi.dispatch_path(g) == "xla" and tapi.dispatch_path(g, dynamic_w=True) == "xla"
    assert g.bat.km_pack == 2  # no measured BAT winner: today's packing
    x = torch.randn(n, 40)
    want = tapi.segment_spmm(g, x, backend="reference")
    assert torch.equal(tapi.segment_spmm(g, x), want)
    vals = torch.randn(len(src), 40)
    calls = []
    real = tapi._IndexScatterBat.apply
    monkeypatch.setattr(tapi._IndexScatterBat, "apply", lambda *a: calls.append(1) or real(*a))
    out = tapi.index_scatter(vals, g.dst, n, plan=g.bat)
    assert calls == [] and torch.allclose(out, tapi.index_scatter(vals, g.dst, n))

    kb128 = theur.bucket_key(128, len(src), n)
    for verdict, decided in (("bat", "table_veto"), ("hybrid", "table_endorse")):
        table({f"spmm_hyb:{kb128}": _cfg(verdict)})
        g = build_graph(src, dst, n, edge_weight=w, layouts=("bat", "stream"), device="cpu")
        assert g.build_stats["stream_decided_by"] == decided
        if decided == "table_veto":
            assert g.hyb is None and "forward" not in g.build_stats["stream"]
        else:
            assert g.build_stats["stream"]["forward"]["margin"] == 1.0


def test_cache_key_changes_with_the_table(table, monkeypatch):
    """The fingerprint is the reference's on the same file, and changes
    with the table's contents."""
    path = table({"spmm:7:20:3": _cfg("bat", 1024, 256)})
    fp = theur.table_fingerprint()
    assert fp == jheur.table_fingerprint() and len(fp) == 10
    table({"spmm:7:20:3": _cfg("bat", 512, 256)})
    assert theur.table_fingerprint() not in (fp, "notable")
    assert theur.table_fingerprint() == jheur.table_fingerprint()
    monkeypatch.setenv(theur.TABLE_ENV, path + ".missing")
    assert theur.table_fingerprint() == "notable" and theur.load_table() == {}


def test_augmentations_equal_reference():
    idx = np.sort(np.random.default_rng(0).integers(0, 50, 400))
    got = list(taugment.augment_sorted_index(idx))
    want = list(jaugment(idx))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert (np.diff(a) >= 0).all()
    assert len(taugment.noise_augment(idx)) == 5
    assert [len(a) for a in taugment.scale_augment(idx)] == [100, 200, 800, 1600]


def test_measure_config_and_sweep_on_cpu(tmp_path):
    """measure_config(device="cpu") times each family's plain versions;
    sweep_graph writes the winners and the verdict key, write_artifacts
    the CSVs and the report renders them."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 60, 300).astype(np.int32)
    dst = rng.integers(0, 60, 300).astype(np.int32)
    for cfg in (theur.KernelConfig("sr", 64, 64, 128), theur.KernelConfig("bat", 64, 32),
                theur.KernelConfig("bat_packed", 64, 32), theur.KernelConfig("xla")):
        for op in tsweep.OPS:
            t = tsweep.measure_config(cfg, src, dst, 60, 16, op=op, iters=2, device="cpu")
            assert t is not None and t > 0, (cfg, op)
    assert tsweep.measure_config(theur.KernelConfig("bat_packed", 64, 32), src, dst, 60, 128,
                                 iters=1, device="cpu") is None
    assert tsweep.measure_config(theur.KernelConfig("pr"), src, dst, 60, 16, iters=1,
                                 device="cpu") is None
    out = str(tmp_path / "table.json")
    best, rows = tsweep.sweep_graph("tiny", src, dst, 60, [16, 100], ops=("spmm", "spmm_dyn"),
                                    iters=1, verbose=False, out_path=out, fast=True,
                                    device="cpu")
    written = json.load(open(out))
    assert set(written) == set(best) and {k.split(":")[0] for k in best} >= {"spmm", "spmm_dyn"}
    for k, (cfg, t) in best.items():
        if not k.startswith("spmm_hyb"):
            cell = [r for r in rows if f"{r.op}:{theur.bucket_key(r.n_features, 300, 60)}" == k]
            assert t == min(r.seconds for r in cell) and written[k]["mode"] == cfg.mode
    tsweep.write_artifacts(rows, str(tmp_path / "results"))
    md = str(tmp_path / "report.md")
    import sys
    argv = sys.argv
    sys.argv = ["report", "--results-dir", str(tmp_path / "results"), "--out", md]
    try:
        treport.main()
    finally:
        sys.argv = argv
    text = open(md).read()
    assert "default knobs" in text and "Config sensitivity" in text


@pytest.mark.parametrize("op", tsweep.OPS)
def test_measure_config_raises_on_a_wrong_or_failing_kernel(op, monkeypatch):
    """A configuration that applies is never dropped from the sweep: sums
    that disagree with the plain route raise AssertionError, and a build
    or launch failure raises as it is (so the plain route cannot win by
    default). Only inapplicable configurations answer None."""
    import geot_tpu_torch.graph.structures as tstruct

    rng = np.random.default_rng(1)
    src = rng.integers(0, 60, 300).astype(np.int32)
    dst = np.sort(rng.integers(0, 60, 300).astype(np.int32))
    cfg = theur.KernelConfig("bat", 64, 32)
    name = "index_scatter" if op == "index_scatter" else "segment_spmm"
    right = getattr(tapi, name)
    monkeypatch.setattr(tapi, name, lambda *a, **k: right(*a, **k) + 1.0)
    with pytest.raises(AssertionError, match="against the plain route"):
        tsweep.measure_config(cfg, src, dst, 60, 16, op=op, iters=1, device="cpu")
    monkeypatch.setattr(tapi, name, right)

    def broken(*a, **k):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(tstruct, "build_graph", broken)
    with pytest.raises(RuntimeError, match="no kernel"):
        tsweep.measure_config(cfg, src, dst, 60, 16, op=op, iters=1, device="cpu")


def test_sweep_main_needs_out(monkeypatch):
    """The sweep's entry point never writes the shipped table unless it is
    named: --out is required."""
    monkeypatch.setattr("sys.argv", ["sweep", "--datasets", "pubmed"])
    with pytest.raises(SystemExit):
        tsweep.main()
