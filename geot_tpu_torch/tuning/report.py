"""Render the sweep's measured artifacts as readable reports.

Port of `geot_tpu/tuning/report.py` over the port's sweep artifacts (the
same CSV columns; the "heuristic" arm is `build_graph`'s default knobs).
The reference ships its tuning validation as paper-artifact scripts
(`artifact/exp2/query_rule.py:30-50` rule-quality bars,
`artifact/exp6/heatmap.py:7-24` config-sensitivity heatmaps). The data
equivalents here are results/tuning_ablation.csv and
results/config_sensitivity.csv (written by `python -m
geot_tpu_torch.tuning.sweep`); this module renders them to markdown so the
numbers are reviewable without a plotting stack.

Run:  python -m geot_tpu_torch.tuning.report [--results-dir results]
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict


def render_ablation(path: str) -> str:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    out = [
        "## Rule quality: build_graph's default knobs vs exhaustive best vs worst",
        "",
        "| graph | op | N | best config | best ms | default knobs | their ms"
        " | worst ms | default/best |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    ratios = []
    for r in rows:
        if r["heuristic_vs_best"]:
            ratios.append(float(r["heuristic_vs_best"]))
        out.append(
            f"| {r['dataset']} | {r['op']} | {r['n_features']} |"
            f" {r['best_cfg']} | {r['best_ms']} | {r['heuristic_cfg']} |"
            f" {r['heuristic_ms'] or 'not measured'} | {r['worst_ms']} |"
            f" {r['heuristic_vs_best'] or '-'} |"
        )
    if ratios:
        gm = 1.0
        for x in ratios:
            gm *= x
        gm **= 1.0 / len(ratios)
        out += [
            "",
            f"Default knobs (empty table) geomean vs exhaustive best: "
            f"**{gm:.3f}x** over {len(ratios)} (graph, op, N) points; a table "
            f"holding the exhaustive winner per bucket pays 1.000x on swept "
            f"shapes by construction.",
        ]
    return "\n".join(out)


def render_sensitivity(path: str) -> str:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    groups = defaultdict(list)
    for r in rows:
        groups[(r["dataset"], r["op"], r["n_features"])].append(r)
    out = [
        "## Config sensitivity (per (graph, op, N): worst/best over the "
        "tile grid)",
        "",
        "| graph | op | N | configs | best ms | worst ms | spread |",
        "|---|---|---|---|---|---|---|",
    ]
    for (ds, op, nf), rs in sorted(groups.items()):
        ts = sorted(float(r["ms"]) for r in rs)
        out.append(
            f"| {ds} | {op} | {nf} | {len(ts)} | {ts[0]:.3f} |"
            f" {ts[-1]:.3f} | {ts[-1] / max(ts[0], 1e-9):.2f}x |"
        )
    out += [
        "",
        "Wrong knobs cost up to the listed spread: the measured table "
        "exists to avoid that (cf. the reference's exp6 heatmap).",
    ]
    return "\n".join(out)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--results-dir", default="results")
    p.add_argument("--out", default="")
    args = p.parse_args()
    parts = ["# Tuning artifacts (measured on the card by geot_tpu_torch/tuning/sweep.py)"]
    abl = os.path.join(args.results_dir, "tuning_ablation.csv")
    sens = os.path.join(args.results_dir, "config_sensitivity.csv")
    if os.path.exists(abl):
        parts.append(render_ablation(abl))
    if os.path.exists(sens):
        parts.append(render_sensitivity(sens))
    text = "\n\n".join(parts) + "\n"
    out = args.out or os.path.join(args.results_dir, "tuning_report.md")
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
