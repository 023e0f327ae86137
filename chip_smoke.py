"""Drive geot_tpu_torch on one CUDA card: build the kernels, hold each
against its plain version, serve inference requests and train GCN,
GraphSAGE, GAT, GIN and APPNP, time it all.

    python3 chip_smoke.py

Runs the port's main paths at full width. Phases 43-44 run the two
command-line scripts (`geot_tpu_torch.scripts.train`, `.train_dist`) as a
user would, on an ogbn-arxiv-shaped labelled data file: 200 epochs of GCN
training with checkpoint, every model's forward timing, and 20 epochs of
the distributed GCN on 2 gloo ranks and 1 NCCL rank. Phases 40-42 drive the parallel
package: the arxiv graph partitioned into 2 and 4 parts, each part's
reduces, then 2 ranks spawned on the one card in a gloo group running the
halo SpMM and 5 requests and 5 Adam steps of the distributed 3-layer GCN,
and NCCL at world size 1. Phases 36-39 drive the native
host runtime, the tuning sweep and table, the compiler pass and the
float64 gradient rule of the norm variants. Phases 30-35 serve and train
the arxiv GCN over bucketed BAT plans (`bucketed_sum`, the edge-row
kernel), with BasicGNN's norms and jumping knowledge, run max and prod on
the card and reload the graph from the cache. Phases 25-29 serve and train
GIN (hidden 64) on the arxiv graph and APPNP (K 10) on the flickr graph
over packed narrow-feature BAT plans (`bat_segment_sum_packed`). Phases 1-9: a 3-layer GCN
(hidden 128, 40 classes) over BAT plans of an ogbn-arxiv-shaped synthetic
graph (169,343 nodes, 1,166,243 edges + self-loops, 128 features).
Phases 10-14: a 3-layer GCN (100 features, hidden 128, 47 classes) over
the hybrid stream+gather plans of an ogbn-products-shaped clustered graph
(2,449,029 nodes, 61,859,140 edges + self-loops; mixing 0.3, communities
of ~2,000 nodes, Zipf(1.0) degrees; the GCN norm baked in). Phases 15-19:
a 3-layer GraphSAGE (mean) and a 3-layer GCN (500 features, hidden 64, 7
classes) over the slot plans of a flickr-shaped graph (89,250 nodes,
899,756 Zipf(1.0) edges, the graph of `benchmarks/bench_models.py`; the
GCN's with self-loops and the norm baked into slot weights), with the
reference tuning table's knobs (`profile_gcn.FLICKR_SLOT`). Phases 20-24:
on the same flickr graph with self-loops and no baked norm, a 3-layer GAT
(hidden 64, 4 heads averaged: `plan_segment_sum_mh`, reading xh[src[e]] in
the edge-row kernel) and a 3-layer GCN
whose norm is a per-call weight (`slot_dyn`), over slot-only plans with
feature_hint 64 (pack-aligned: `plan_segment_sum_packed2`) and 128
(`plan_segment_sum_sr2`). Weights come from a seeded torch.Generator.
Phases, each printed with its elapsed seconds:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (nvcc, sm_90a, one process per source, in parallel)
     with the ptxas report;
  3. bat_segment_sum (the row-ordered edge sum of edge_row_sum.cu) against
     bat_segment_sum_plain on the card over bat and bat_t at F 128, 100, 47
     and 40, weighted and unweighted, in both forms (x[src[e]] read in the
     kernel; edge-order values), reruns bit-identical; and its route over a
     plan forced into chunks with a split hub window and over a uniformized
     chunked plan whose pad tiles point past the next chunk, one launch a
     plan, bit-identical to the whole plan;
  4. 5 inference requests (GCN forward passes), counting kernel launches,
     each held against the same model on the plain reference path;
  5. CUDA-event timings of bat_segment_sum in both forms at F 128 and 40,
     the [E, F] gather alone, its plain version, both bounds, the library
     yardsticks (torch.sparse.mm, never called by the port: the node CSR
     for the gathered form, the edge -> row CSR for the values form), one
     SpMM and one forward pass;
  6. sddmm_bat against sddmm_bat_plain at the real plan and at a
     uniformized chunked plan whose pad tiles point past n_blocks, in both
     forms (b in edge order; a[dst[e]] and b[src[e]] read in the kernel),
     with bit-identical reruns;
  7. the weight gradient through the entry point gather_weight_scatter:
     dx and dw against the reference backend, and the backward's launches
     (one sddmm_bat, one bat_segment_sum over each of bat and bat_t); and
     sddmm_coo with the graph (one sddmm_bat) against sddmm_coo_ref;
  8. 5 AdamW training steps of the GCN (lr 0.01, weight decay 5e-4), each
     beside the same step on the reference path from the same state:
     first-step gradients and every loss compared, launches per step
     asserted;
  9. CUDA-event timings of a training step, a backward SpMM over the
     transpose plan, bat_segment_sum over bat_t in both forms, sddmm_bat
     in both forms with both bounds (a's and b's rows once; each edge's b
     row once), the old route's padding and [E, F] gather, its plain
     version and the library yardstick (torch.sparse.sampled_addmm, never
     called by the port);
 10. the products-clustered graph's host build, with the seconds of each
     step, each direction's split (stream share, families, remainder, each
     family's kernel schedule, the remainder's edge-row schedule), and
     dispatch_path == "hybrid";
 11. stream_segment_sum and stream_segment_acc against their plain
     versions on every stream family of both directions (the forward's and
     the backward's), weighted, at F 128 and at the last layer's F 47, and
     the remainder's bat_segment_sum on both directions' plans (gathered at
     F 128 and 47, values at 47), with bit-identical reruns;
 12. 5 GCN requests over the hybrid path, each against the reference path
     (plain, over edge chunks) run in float64, launches per request
     asserted;
 13. 5 AdamW training steps over the hybrid path, each beside the same step
     on the reference path, launches per step asserted;
 14. CUDA-event timings of each stream kernel per family at F 128 and 47,
     the device time of its main pass and of its fix-up pass (torch.profiler),
     its plain version, its bound (with the bytes of its schedule beside
     it; and beside it the bound with each live slot's x row counted once), the library yardstick (torch.sparse.mm over the family's own CSR
     adjacency), the remainder's bat_segment_sum in both forms per
     direction at F 128 and 47 (phase 5's yardsticks), one hybrid SpMM, one
     forward pass, one training step and torch.sparse.mm over the whole
     weighted adjacency;
 15. the flickr graph's host build for each model, and dispatch_path ==
     "slot" (GraphSAGE, mean) and "slot_static" (GCN);
 16. plan_segment_sum_sr (F 500, 128) and plan_segment_sum_sr_packed (F
     64, 32, 16, 8, 7), both the edge-row kernel, in both forms (slot-order
     values and x[src[e]] read in the kernel), and plan_segment_sum_pr (8
     rows, both forms) against their plain versions on both directions'
     real plans, with bit-identical reruns; the mean's degree
     (segment_counts: pr over ones [1, slots]) equal to the in-degree; the
     slot SpMM over a plan chunked so that its hub window splits
     (sr_packed at F 64 and sr at F 128 once each, the plan whole), and pr
     and the degree over it, the plan whole;
 17. 5 requests per model, launches per request asserted (GraphSAGE: sr
     1, sr_packed 2, pr 3; GCN: sr_packed 3), each against the same model
     on the plain reference path;
 18. 5 AdamW training steps per model beside the reference path (launches
     per step: GraphSAGE sr 1, sr_packed 4, pr 3; GCN sr_packed 6); the
     step-0 gradients against the reference path in float32 and with its
     sums in float64, both differentiated through the kernel path's ReLU
     pattern;
 19. CUDA-event timings of each slot kernel at its main-path shape, its
     plain version, the library yardstick (torch.sparse.mm over the plan's
     slot -> row CSR; sr's and sr_packed's gathered form too, over the node
     CSR, with the [slots, F] gather alone and the bound with each live
     edge's row once beside x's rows once; pr at the degree's [1, slots],
     at [8, slots] and gathered at F 8, with the old route's [slots, 8]
     gather and transpose), the slot SpMM per layer width, each
     model's forward and training step, and each one's busy share
     (profile_gcn.trace);
 20. the three graphs' host build (GAT; GCN at feature_hint 64 and 128)
     with their edge-row schedules, dispatch_path == "slot_dyn" for the
     per-call weights, the AEB name each width launches under, the name of
     GAT's route, and build_graph with its default layouts (the reference's);
 21. plan_segment_sum_mh ((H, D) = (4, 64), (4, 7), (3, 96), (8, 32), with
     weights exactly 0 on chosen heads and on every head, in both forms:
     slot-order values and weights; xh[src[e]] read in the edge-row kernel
     with edge-order weights), plan_segment_sum_sr2 (slot values
     with per-call weights, edge values with static and/or per-call
     weights; F 500, 128, 64) and plan_segment_sum_packed2 (F 64, 32, 16,
     8), and both in the gathered form (x[src[e]] read in the edge-row
     kernel; F 128, 64, 7 and 64-7) against their plain versions on both
     directions' real plans, with every third per-call weight exactly 0 too
     and bit-identical reruns; edge_dots (the per-edge, per-head dot of
     GAT's attention gradient) at (H, D) = (4, 64) and (4, 7) over GAT's
     edges in both forms; each one's route over a plan chunked so that
     its hub window splits (sr2 / packed2 / mh: the whole plan in one
     launch);
 22. 5 requests per model, launches per request asserted (GAT: mh 3 and
     edge_softmax 3; GCN: packed2 3 / sr2 3), each against the same model
     on the reference path in float64;
 23. 5 AdamW steps per model beside the reference path (launches per step:
     GAT mh 6, 3 forward and 3 for the xh gradient over plan_t, edge_dots
     3, the attention's gradient, edge_softmax 3 and edge_softmax_grad 3;
     GCN packed2 3 / sr2 3 and
     sr_packed 3 over plan_t), the step-0 gradients against the reference
     path in float32 and in float64 through the kernel path's ReLU
     pattern; then gat_attention_spmm's composed route (fused_max_edges 0)
     at H*D 256 and 28, one forward and backward against the default route
     (one computation on the card);
 24. CUDA-event timings of each kernel at its main-path shapes, its
     plain version, the library yardstick (torch.sparse.mm over the plan's
     CSR with the kernel's weights); mh, sr2 and packed2 in both forms
     (slot- or edge-order values against the slot or edge -> row CSR;
     gathered against the node [n, n] CSR, the whole SpMM, head-expanded
     for mh: [n*H, n*H]), mh with the [slots, H*D] gather alone and both
     bounds (x's rows once; each live edge's row once); edge_dots at H*D
     256 and 28 in both forms with both bounds and its plain version (the
     parent's route);
     each model's forward and training step, and each one's busy share;
 25. the narrow BAT path's host builds: GIN's arxiv graph (phases 1-9's,
     no self-loops, unweighted; feature_hint 64: km_pack 2) and APPNP's
     flickr graph (phases 15-24's, self-loops, no baked norm; feature_hint
     7: km_pack 16), 512 x 256 BAT tiles only, with km_pack, the dst_km
     shapes and chunks of bat and bat_t, and dispatch_path "bat" (GIN) and
     "bat_dyn" (APPNP's per-call norm);
 26. bat_segment_sum_packed against its plain version at each pack (16
     and 2 on the two graphs' real plans, both directions; 8 and 4 on
     plans of the flickr edges), in both forms (edge-order values; x[src[e]]
     read in the kernel), unweighted, weighted and with every third weight
     0, three reruns bit-identical; and its route at ragged widths (F 7 and
     40, padded to 8 and 64) over the whole plan and a plan forced into
     chunks that split the hub window, one launch a plan;
 27. 5 requests of GIN (3 layers, 128 -> 64 -> 64 -> 40: bat_segment_sum 1
     and bat_segment_sum_packed 2 per request) and of APPNP (MLP 500 -> 64
     -> 7, K 10, alpha 0.1: bat_segment_sum_packed 10 with weights; the
     packed routes read x[src[e]] in the kernel, no edge-order gather), each
     against the same model on the reference path in float64;
 28. 5 AdamW steps of each, each beside the same step on the reference
     path from the same state (launches per step:
     GIN wide 1, packed 2 + 2 over bat_t; APPNP packed 10 + 10 over bat_t;
     no sddmm_bat: the norm takes no gradient), step-0 gradients at phase
     8's rule, every loss compared;
 29. CUDA-event timings of the packed kernel at each real shape (both
     graphs, both directions) in both forms, its plain version, its bound,
     the library yardstick (torch.sparse.mm, never called by the port:
     over the edge -> row CSR for the values form, over the node [n, n]
     CSR for the gathered one, at the same width and weights) and the wide
     bat_segment_sum on the same values padded to 128 columns over an
     unpacked plan (what a narrow layer cost before); each model's request
     and training step, and each one's busy share;
 30. phases 1-9's arxiv graph built again with the GCN norm baked in and
     bucketed BAT plans (layouts ("bat",), bucket_table_bytes=1: two
     buckets of 131,072 rows): the build's seconds, each plan's tiles,
     chunks and edge-row schedule, and dispatch_path == "bucketed";
 31. bucketed_sum (the edge-row kernel over the bucketed plan, reading
     x[src[e]] by global ids) against bucketed_sum_plain (the reference's
     chunk order) over bat_b and bat_b_t at F 128 and 40, one launch a
     plan, three reruns bit-identical;
 32. 5 requests and 5 AdamW steps of the GCN (conv_kwargs normalize False)
     over the bucketed route, and 2 of each for GCN with norm "layer" and
     jk "cat", and with norm "batch", jk "max" and act_first: each request
     against the reference path in float64 (the f32 one's distance
     logged), each step beside the reference path, launches asserted
     (bat_segment_sum 3 a request, 6 a step; nothing else); the norm
     variants' step-0 gradients go to phase 39;
 33. CUDA-event timings of the bucketed SpMM beside the bat_static SpMM on
     the same graph at F 128 and 40, its bound, its plain version and
     torch.sparse.mm over the node CSR; each model's forward and step;
 34. segment_spmm(reduce="max") and (reduce="prod") on the card (the plain
     route: segment_reduce over the dst-sorted runs) against the CPU's,
     reruns bit-identical;
 35. save_graph / load_graph of the bucketed graph: the load's seconds
     beside the build's, the graph and its schedules back on the card, and
     a request through it bit-identical to the built graph's;
 36. the native host runtime (g++, `geot_tpu_torch.native`) built and
     loaded; phases 1-9's arxiv graph built through it and through numpy
     (slot plans at pack_align 1, BAT and bucketed BAT plans, both sorts):
     every array equal, both host times (phases 10, 15, 20, 25 and 30 build
     through it too);
 37. the tuning sweep (`tuning.sweep.sweep_graph`, the fast space: bat,
     bat_packed, sr, the plain route, hybrid) on the arxiv graph at F 128
     and 40 for spmm and spmm_dyn into a temporary table, every
     configuration's time; the hybrid candidate on an arxiv-size clustered
     graph (the stream kernels); select_config under that table gives each
     bucket's measured winner, build_graph builds its knobs and its SpMM
     (graph and per-call weights) is within the abs-sum rule of the plain
     version; under an empty table prepare_graph gives phase 30's graph;
 38. the compiler pass (`compiler.pattern_transform`): a two-layer GCN in
     plain PyTorch (index_select -> mul -> index_add_) over the arxiv
     graph, two matches, the rewritten forward within the abs-sum rule of
     the unrewritten function and of float64, its launches (2
     bat_segment_sum forward; 2 over bat_t and 2 sddmm_bat backward), its
     gradients against the unrewritten function's in float64 through the
     rewritten path's ReLU pattern (the f32 one's distance logged), the
     rewritten and unrewritten
     times; the multi-head pattern on the GAT graph (plan_segment_sum_mh,
     and edge_dots backward);
 39. phase 32's norm variants' step-0 gradients held per tensor against the
     reference path in float64 (ROADMAP C.19): the kernel path's relative
     distance ||g - g64|| / ||g64|| at most twice the f32 reference
     path's;
 40. `parallel.partition_graph` of phases 1-9's arxiv graph (the GCN norm
     of the whole graph as edge weights) into 2 and 4 parts by layout
     "auto" (it must pick "slot") and "bat", and of phase 37's clustered
     graph (arxiv size, communities of 32, mixing 0.02; self-loops and the
     GCN norm) into 2 parts by "hybrid" (the census must stream): each
     one's host seconds, halo H, interior share of the edges, tiles and
     chunks;
 41. every part's reduces of those partitions on the card against their
     plain versions, both directions, at F 128 and 40: the slot plans' sr
     and sr_packed (x[src[e]] read in the edge-row kernel), the BAT
     families' bat_segment_sum (each part's equalized plan whole), the
     streamed cells' stream_segment_sum and stream_segment_acc; the
     abs-sum rule; three reruns bit-identical;
 42. 2 ranks spawned on cuda:0 in a gloo group (`parallel.spawn_ranks`;
     gloo stages CUDA tensors through the host, and NCCL takes one rank a
     card): halo_spmm forward and x gradient over each layout's 2-part
     partition against the same rank on the reference backend and the
     whole graph's SpMM in float64 (the blocked pad rows 0, reruns
     bit-identical); 5 requests and 5 Adam steps (lr 0.01) of the GCN 128
     -> 128 -> 128 -> 40 over the slot partition, launches per request
     and per step asserted, each request against the whole graph's GCN in
     float64 (MODEL_TOL), each step's loss against float64 from the same
     state, the step-0 gradients through the kernel path's ReLU pattern
     (gathered from both ranks), the losses bit-identical across ranks;
     CUDA-event times of a request, a step, one exchange alone (gloo,
     host-staged) at F 128 and 40, one halo_spmm and its interior reduce;
     rank 0 then runs halo_spmm over a 1-part partition in a 1-rank NCCL
     group, against float64, and times its exchange.
 43. the training script `geot_tpu_torch.scripts.train`, called in-process
     on a data file written for it (`synthetic_classification_graph` at
     ogbn-arxiv's shape, 40 homophilous classes, 128 features, in
     `load_npz`'s format): 200 epochs of the GCN (hidden 128, 3 layers,
     AdamW, evaluations every 10 epochs, the best validation's parameters,
     a checkpoint) on the kernel path and on the reference path; train
     accuracy > 0.9 and validation > 0.75, the two runs' accuracies within
     0.01 and final losses within 1e-2 relative, the kernel run's launches
     (bat_segment_sum 6 a step and 3 an evaluation) and none on the
     reference path; the checkpoint loaded into a fresh GCN giving the
     same accuracies bit for bit; `--time-only` of every model of MODELS
     (10 warm-up and 100 timed forwards, launches a multiple of 110) into
     one CSV under one header; and `python -m
     geot_tpu_torch.scripts.train --time-only` as a subprocess (started
     before the training runs, waited for before the timings), exit 0;
 44. the distributed script `geot_tpu_torch.scripts.train_dist`
     in-process on the same file (hidden 128, 3 layers, 20 epochs): 2
     gloo ranks sharing cuda:0 and 1 NCCL rank, both over the slot
     partition; losses at epochs 10 and 20 within 1e-3 relative and
     accuracies within 0.01 of each other, the loss at epoch 20 below
     epoch 10's and ln 40, each rank's launches per step and per
     evaluation phase 42's (plan_segment_sum_sr 8 and _sr_packed 4 a
     step; 4 and 2 an evaluation).
 45. the edge softmax (`ops/csrc/edge_softmax.cu`) on the arxiv-gat
     benchmark cell's graph (ogbn-arxiv's 169,343 nodes and 1,166,243
     Zipf(1.0) edges, bidirected, deduplicated, self-loops: 2,428,629
     edges, a 71,237-edge hub row) with 3 heads, and on a small random
     graph with a hub row cut into many chunks at 1, 3 and 8 heads: both
     entry points (GAT's per-node terms, `segment_softmax`'s per-edge
     logits), forward and both gradients against the plain version on the
     card in float64 from the same float32 inputs (att within 1e-6
     relative per element, the gradients within 1e-5 of their largest
     element; the plain version's own float32 distance logged beside: its
     index_add_ sums run in any order), three reruns bit-identical, one
     counted launch a call; then device times of the forward and the
     backward alone at the cell's shapes (torch.profiler, per kernel; three
     rounds, with the card's SM clock read before each) and back to back
     (CUDA events), beside the plain version's and the bound.

Prints one JSON line of per-kernel results, then as the last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0); a phase
that stalls past its budget ends the process. Needs a CUDA card: it never
falls back to the CPU.
"""

import copy
import dataclasses
import faulthandler
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch

T0 = time.perf_counter()
SEED = 0
REQUESTS = 5
TRAIN_STEPS = 5
PHASE_BUDGET_S = {"build": 200, "kernel": 120, "serve": 180, "timing": 120,
                  "sddmm": 120, "grad": 120, "train": 240, "timing_train": 180,
                  "hyb_build": 420, "hyb_kernel": 240, "hyb_serve": 240,
                  "hyb_train": 360, "hyb_timing": 300, "slot_build": 120,
                  "slot_kernel": 180, "slot_serve": 120, "slot_train": 180,
                  "slot_timing": 240, "gat_build": 120, "gat_kernel": 240, "gat_serve": 180,
                  "gat_train": 240, "gat_timing": 240, "narrow_build": 180,
                  "narrow_kernel": 240, "narrow_serve": 180, "narrow_train": 240,
                  "narrow_timing": 240, "bucket_build": 120, "bucket_kernel": 120,
                  "bucket_serve": 240, "bucket_timing": 180, "bucket_reduce": 120,
                  "bucket_cache": 180, "native": 120, "tune": 300, "compiler": 180, "c19": 60,
                  "par_build": 180, "par_kernel": 240, "par_run": 600,
                  "cli_train": 300, "cli_dist": 300, "softmax": 300}
# kernel vs plain: two f32 sums of the same terms in different orders (the
# kernel in edge order or lane by lane, the plain version with index_add_
# or sum). Allowed error per element: 1e-4 * sum|terms| + 1e-5, about 1700
# f32 roundings of the magnitude — above the sqrt(n)*u growth of a
# ~92k-term hub row.
KERNEL_RTOL_ABS_SUM, KERNEL_ATOL = 1e-4, 1e-5
# GCN outputs (O(1) values): kernel path vs the plain reference path
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4       # per training step, kernel path vs reference path
GRAD_RTOL = 1e-4       # first-step gradients: rtol, atol = GRAD_RTOL * max|g_ref|
# hidden pre-activations whose sign may differ between the kernel path and a
# reference path (phase 18), each within FLIP_RTOL * max|z| of its layer of 0
FLIP_MAX, FLIP_RTOL = 16, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
LR, WEIGHT_DECAY = 0.01, 5e-4
# the hybrid path's graph: DATASET_SHAPES["ogbn-products"] widths
HYB_MIXING, HYB_COMMUNITY = 0.3, 2000


def log(msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def arm(phase):
    """A phase that outlasts its budget ends the process with a traceback
    (this also covers a hang inside a CUDA call)."""
    faulthandler.cancel_dump_traceback_later()
    faulthandler.dump_traceback_later(PHASE_BUDGET_S[phase], exit=True)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close_abs_sum(k, p, abs_sum, what):
    err = (k - p).abs()
    lim = KERNEL_RTOL_ABS_SUM * abs_sum + KERNEL_ATOL
    bad = int((err > lim).sum())
    mx = float(err.max())
    rel = float((err / p.abs().clamp(min=1e-6)).max())
    log(f"{what}: max_abs_err={mx:.3e} max_rel_err={rel:.3e} over_tolerance={bad}")
    if bad or not torch.isfinite(k).all():
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return mx


def bound_ms(n_bytes, n_flops):
    """The least time for the work: bytes at the HBM rate or f32 flops at
    the f32 rate, whichever is larger; and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def expect_launches(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def stream_bound(sp, F, n_x_rows, accumulate):
    """The least time of one stream kernel launch (its bytes read once and
    written once: the slot metadata, the x blocks its tiles name, the read
    and write of the visited windows (accumulate) or the write of every
    window (sum); or its f32 flops, 2 per real edge and column), and its
    bytes; and beside it the bound with each live slot's x row counted
    once (`rows_ms`, `rows_bytes`): the row reads the kernel issues, which
    the bound above counts once per x block (most of them hit L2)."""
    T, E, s = sp.num_tiles, sp.e_tile, sp.s_tile
    meta = T * E * (8 + (4 if sp.w3 is not None else 0)) + T * 8
    blocks = torch.unique(sp.sblock.long())
    x_rows = (torch.clamp(n_x_rows - blocks * sp.x_rows, max=sp.x_rows, min=0)).sum()
    x_bytes = int(x_rows) * F * 4
    visited = int(torch.unique(sp.out_block).numel())
    win_bytes = s * F * 4
    out_bytes = 2 * visited * win_bytes if accumulate else sp.n_blocks * win_bytes
    n_bytes = meta + x_bytes + out_bytes
    bound, by = bound_ms(n_bytes, 2 * sp.num_edges * F)
    rows_bytes = meta + int(sp.cols.shape[0]) * F * 4 + out_bytes
    rows_ms, _ = bound_ms(rows_bytes, 2 * sp.num_edges * F)
    return bound, by, n_bytes, rows_ms, rows_bytes


def schedule_bytes(sp):
    """The bytes of the kernel's own schedule (`kernel_schedule`'s arrays),
    logged beside the bound and not folded into it."""
    ts = (sp.cols, sp.vals, sp.unit_dest, sp.tasks, sp.zero_runs, sp.fix)
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def schedule_note(sp):
    cut = int((sp.fix[:, 0] >= 0).sum()) if sp.fix.shape[0] else 0
    return (f"{sp.cols.shape[0]} live slots, {sp.unit_dest.shape[0]} units, {cut} rows cut "
            f"into {int((sp.unit_dest < 0).sum())} slices, {len(sp.fix_levels) - 1} fix-up "
            f"levels, {sp.tasks.shape[0] - 1} tasks")


def pass_ms(fn, iters=5):
    """Device ms per call of the stream kernel's main pass and of its
    fix-up pass (torch.profiler)."""
    from geot_tpu_torch.profile_gcn import trace

    _, _, _, events = trace(fn, iters, warmup=1)
    main = sum(ev.time_range.elapsed_us() for ev in events if "stream_row_kernel" in ev.name)
    fix = sum(ev.time_range.elapsed_us() for ev in events if "stream_fix_kernel" in ev.name)
    return main / 1e3 / iters, fix / 1e3 / iters


def pad_tiles(sp):
    """The all -1 tiles the reference's uniformized chunks would add to
    this family (the port's plans leave them out)."""
    per = [t1 - t0 for t0, t1, _, _ in sp.chunks]
    return len(per) * max(per, default=0) - sum(per)


def family_csr(sp, n):
    """The family's own weighted adjacency [n, n] in CSR (for the library
    yardstick only)."""
    keep = sp.srcl3.reshape(-1) >= 0
    rows = sp.dst3.reshape(-1)[keep].long()
    cols = (sp.sblock.long()[:, None] * sp.x_rows + sp.srcl3.reshape(sp.num_tiles, -1).long())
    cols = cols.reshape(-1)[keep]
    vals = sp.w3.reshape(-1)[keep]
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                   check_invariants=False).coalesce().to_sparse_csr()


def bat_timing(plan, xf, src_d, dst_d, w, card, what, plain=True):
    """Both forms of bat_segment_sum over `plan` at x's width (x[src[e]]
    read in the kernel, as the routes run it; edge-order values), with the
    [E, F] gather alone, the bounds, the plain version (unless `plain` is
    False) and the library yardsticks (torch.sparse.mm, never called by the
    port: the node CSR for the gathered form, the edge -> row CSR for the
    values form) beside them."""
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

    Fx, rows, nnz = xf.shape[1], plan.n_blocks * plan.s_tile, int(src_d.shape[0])
    vals_d = xf.index_select(0, src_d.long())
    r = {"F": Fx}
    r["ms"] = cuda_ms(lambda: bat_segment_sum(plan, xf, w, src=src_d))
    r["values_ms"] = cuda_ms(lambda: bat_segment_sum(plan, vals_d, w))
    r["gather_ms"] = cuda_ms(lambda: xf.index_select(0, src_d.long()))
    if plain:
        r["plain_ms"] = cuda_ms(lambda: bat_segment_sum_plain(plan, xf, w, src=src_d),
                                iters=3, warmup=1)
    r["bound_ms"], r["bound_by"], nb_g = gathered_bound(xf.shape[0], Fx, nnz, w is not None,
                                                        rows)
    # the values form's inputs: the [E, F] rows, dst3, the weights, the
    # tiles; the output once
    nb_v = (vals_d.numel() * 4 + plan.dst3.numel() * 4 + (nnz * 4 if w is not None else 0)
            + plan.num_tiles * 8 + rows * Fx * 4)
    r["values_bound_ms"], r["values_bound_by"] = bound_ms(
        nb_v, (2 if w is not None else 1) * nnz * Fx)
    ncsr = node_csr(dst_d, src_d, w, xf.shape[0])
    r["library_ms"] = cuda_ms(lambda: torch.sparse.mm(ncsr, xf))
    del ncsr
    ecsr = edge_csr(dst_d, w, rows)
    r["values_library_ms"] = cuda_ms(lambda: torch.sparse.mm(ecsr, vals_d))
    del ecsr, vals_d
    log(f"{card} bat_segment_sum {what} F={Fx}: gathered (x[src[e]] in the kernel) "
        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}: "
        f"{nb_g / 1e9:.4f} GB, x's rows once), library torch.sparse.mm (node CSR) "
        f"{r['library_ms']:.4f} ms || values form {r['values_ms']:.4f} ms (bound "
        f"{r['values_bound_ms']:.4f} ms: {nb_v / 1e9:.4f} GB), library (edge -> row CSR) "
        f"{r['values_library_ms']:.4f} ms; the [E, F] gather alone {r['gather_ms']:.4f} ms"
        + (f"; plain {r['plain_ms']:.4f} ms" if plain else ""))
    return r


def run_hybrid(dev, card):
    """Phases 10-14: GCN serving and training over the hybrid stream+gather
    path on the ogbn-products-shaped clustered graph. Returns the numbers
    for the kernels line."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_clustered_graph
    from geot_tpu_torch.models import GCN, make_optimizer, make_train_step, prepare_graph
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain
    from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat
    from geot_tpu_torch.ops.stream_kernels import (
        stream_segment_acc,
        stream_segment_acc_plain,
        stream_segment_sum,
        stream_segment_sum_plain,
    )

    counters = {"stream_segment_sum": stream_segment_sum,
                "stream_segment_acc": stream_segment_acc,
                "bat_segment_sum": bat_segment_sum, "sddmm_bat": sddmm_bat}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # 10. host build
    arm("hyb_build")
    n, e, f, c = DATASET_SHAPES["ogbn-products"]
    t0 = time.perf_counter()
    data = synthetic_clustered_graph(n, e, mixing=HYB_MIXING, mean_community=HYB_COMMUNITY,
                                     power=1.0, feat_dim=f, num_classes=c, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = prepare_graph(data.src, data.dst, n, normalize="gcn", layouts=("bat", "stream"),
                      device=dev)
    t_prep = time.perf_counter() - t0
    secs = g.build_stats["seconds"]
    log(f"phase 10 host build: generate {t_gen:.2f}s; prepare_graph {t_prep:.2f}s "
        f"(self-loops + gcn norm {t_prep - sum(secs.values()):.2f}s, "
        + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items()) + ")")
    log(f"graph: {n} nodes, {g.num_edges} edges (self-loops added), x [{n}, {f}]")
    for direction, hyb in (("forward", g.hyb), ("transpose", g.hyb_t)):
        st = g.build_stats["stream"].get(direction)
        if st is None:
            log(f"  {direction} split: not built (the forward split was rejected)")
            continue
        fams = ", ".join(f"E={sp.e_tile}: {sp.num_tiles} tiles ({pad_tiles(sp)} chunk pad "
                         f"tiles of the reference left out), {max(len(sp.chunks), 1)} "
                         f"chunks, {sp.num_edges} edges; kernel schedule: {schedule_note(sp)}"
                         for sp in (hyb.stream if hyb is not None else ()))
        log(f"  {direction} split: stream_frac={st['stream_frac']:.4f}, "
            f"est hybrid {st['est_hybrid_ms']:.1f} vs margin {st['margin']} x all-BAT "
            f"{st['est_all_bat_ms']:.1f} (census model units); families [{fams}]; "
            f"remainder {st['rest_edges']} edges"
            + (f" in {max(len(hyb.rest.chunks), 1)} BAT chunk(s)" if hyb and hyb.rest else ""))
    path = api.dispatch_path(g)
    if path != "hybrid":
        raise AssertionError(f"dispatch_path is {path!r}, expected 'hybrid'")
    log("phase 10 dispatch_path(graph) == 'hybrid'; the remainders' edge-row schedules "
        "(built inside rest_bat_plan_*): " + ", ".join(
            f"{k} {v['seconds']:.2f}s {v['bytes'] / 1e6:.1f} MB"
            for k, v in g.build_stats["row_schedule"].items()))
    hyb, hyb_t = g.hyb, g.hyb_t
    x = torch.from_numpy(data.x).to(dev)

    # 11. both stream kernels against plain on every family the main path
    # runs: the forward's and the transpose's (the backward), at F 128 (the
    # hidden layers) and F 47 (the last layer; not a multiple of 4, so the
    # kernel's scalar loads and stores)
    arm("hyb_kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x128 = torch.randn(n, 128, generator=gen, device=dev)
    errs = {"stream_segment_sum": 0.0, "stream_segment_acc": 0.0}
    for F in (128, c):
        xf = x128 if F == 128 else torch.randn(n, F, generator=gen, device=dev)
        for direction, h in (("forward", hyb), ("transpose", hyb_t)):
            for sp in h.stream:
                what = f"phase 11 {direction} E={sp.e_tile} F={F}"
                sp_abs = dataclasses.replace(sp, w3=sp.w3.abs())
                carry0 = torch.randn(sp.n_blocks * sp.s_tile, F, generator=gen, device=dev)
                k = stream_segment_sum(sp, xf)
                torch.cuda.synchronize()
                p = stream_segment_sum_plain(sp, xf)
                a = stream_segment_sum_plain(sp_abs, xf.abs())
                errs["stream_segment_sum"] = max(errs["stream_segment_sum"], check_close_abs_sum(
                    k, p, a, f"{what} stream_segment_sum"))
                if not torch.equal(stream_segment_sum(sp, xf), k):
                    raise AssertionError(f"{what}: stream_segment_sum is not deterministic")
                k = stream_segment_acc(sp, xf, carry0.clone())
                torch.cuda.synchronize()
                p = stream_segment_acc_plain(sp, xf, carry0.clone())
                a = stream_segment_acc_plain(sp_abs, xf.abs(), carry0.abs())
                errs["stream_segment_acc"] = max(errs["stream_segment_acc"], check_close_abs_sum(
                    k, p, a, f"{what} stream_segment_acc"))
                if not torch.equal(stream_segment_acc(sp, xf, carry0.clone()), k):
                    raise AssertionError(f"{what}: stream_segment_acc is not deterministic")
    log("phase 11 reruns bit-identical on every family, both directions, F 128 and "
        f"F {c}")
    del k, p, a, carry0, xf
    # the remainder's bat_segment_sum, both directions: gathered (x[src[e]],
    # as the route runs it) at F 128 and 47, the values form at 47 (its
    # [24.6 M, 128] block and the plain version's copies would take ~40 GB)
    errs["bat_segment_sum"] = 0.0
    for F in (128, c):
        xf = x128 if F == 128 else torch.randn(n, F, generator=gen, device=dev)
        for direction, h in (("forward", hyb), ("transpose", hyb_t)):
            rp, rs, rw = h.rest, h.rest_src, h.rest_w
            forms = [("gathered", xf, rs)]
            if F != 128:
                forms.append(("values", xf.index_select(0, rs.long()), None))
            for form, xv, src in forms:
                what = f"phase 11 {direction} remainder bat_segment_sum F={F} {form}"
                k = bat_segment_sum(rp, xv, rw, src=src)
                torch.cuda.synchronize()
                p = bat_segment_sum_plain(rp, xv, rw, src=src)
                a = bat_segment_sum_plain(rp, xv.abs(), None if rw is None else rw.abs(),
                                          src=src)
                errs["bat_segment_sum"] = max(errs["bat_segment_sum"],
                                              check_close_abs_sum(k, p, a, what))
                del p, a
                if not torch.equal(bat_segment_sum(rp, xv, rw, src=src), k):
                    raise AssertionError(f"{what}: not deterministic")
                del k
            del forms
    log("phase 11 the remainder's bat_segment_sum within the abs-sum rule on both "
        "directions' plans, reruns bit-identical")
    del xf

    # 12. serve: GCN requests over the hybrid path
    arm("hyb_serve")
    kw = dict(conv_kwargs={"normalize": False}, device=dev)
    model = GCN(f, 128, 3, c, generator=torch.Generator().manual_seed(SEED), **kw).eval()
    ref_model = GCN(f, 128, 3, c, backend="reference", **kw).eval()
    ref_model.load_state_dict(model.state_dict())

    def per_spmm(h):
        return {"stream_segment_sum": 1, "stream_segment_acc": len(h.stream) - 1,
                "bat_segment_sum": 0 if h.rest is None else 1,
                "sddmm_bat": 0}

    fwd = {k: 3 * v for k, v in per_spmm(hyb).items()}
    outs, req_s = [], []
    reset()  # count the serving path's launches only
    with torch.inference_mode():
        for i in range(REQUESTS):
            before = counts()
            ts = time.perf_counter()
            out = model(x, g)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - ts)
            expect_launches({k: v - before[k] for k, v in counts().items()}, fwd,
                            f"hybrid request {i}")
            outs.append(out)
    serve = counts()
    log(f"phase 12 serve: {REQUESTS} requests, launches {serve} "
        f"(per request {fwd}); request s: " + ", ".join(f"{t:.4f}" for t in req_s))
    # the oracle: the reference path (plain, over edge chunks) in float64.
    # In float32 its hub rows (up to ~4 M terms, summed by index_add_ in
    # whatever order the atomics take) carry an error of their own near
    # 1e-4, so the float32 reference path is logged against it too.
    ref64 = GCN(f, 128, 3, c, backend="reference", **kw).double().eval()
    ref64.load_state_dict(model.state_dict())
    with torch.inference_mode():
        ref = ref64(x.double(), g).float()
        ref32 = ref_model(x, g)
    del ref64

    def rel_excess(a):
        err = (a - ref).abs()
        lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * ref.abs()
        return float(err.max()), int((err > lim).sum())

    for i, out in enumerate(outs):
        if out.shape != (n, c) or not torch.isfinite(out).all():
            raise AssertionError(f"hybrid request {i}: bad output {tuple(out.shape)}")
        torch.testing.assert_close(out, ref, **MODEL_TOL)
    mx, bad = rel_excess(outs[0])
    mx32, bad32 = rel_excess(ref32)
    log(f"phase 12 check: outputs [{n}, {c}] finite; against the float64 reference path "
        f"(tolerance {MODEL_TOL}): hybrid path max abs err {mx:.3e}, {bad} over; "
        f"float32 reference path max abs err {mx32:.3e}, {bad32} over")
    del outs, ref, ref32, out

    # 13. train: AdamW steps, hybrid path beside the reference path
    arm("hyb_train")
    ref_model.load_state_dict(model.state_dict())
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    step = make_train_step(model, make_optimizer(model, LR, WEIGHT_DECAY), has_dropout=False)
    ref_step = make_train_step(ref_model, make_optimizer(ref_model, LR, WEIGHT_DECAY),
                               has_dropout=False)
    # the backward sums over hyb_t, but a layer that widens (100 -> 128)
    # sums first and sums over hyb again in its backward (`GCNConv`)
    bwd = {k: sum(per_spmm(hyb if conv.aggregate_first else hyb_t)[k] for conv in model.convs)
           for k in fwd}
    per_step = {k: fwd[k] + bwd[k] for k in fwd}
    losses, step_s = [], []
    reset()  # count the training path's launches only
    for i in range(TRAIN_STEPS):
        before = counts()
        ts = time.perf_counter()
        loss = step(x, g, y, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        expect_launches({k: v - before[k] for k, v in counts().items()}, per_step,
                        f"hybrid step {i}")
        loss_r = ref_step(x, g, y, mask)
        if i == 0:
            pr = dict(ref_model.named_parameters())
            for name, prm in model.named_parameters():
                gr = pr[name].grad
                torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                           atol=GRAD_RTOL * float(gr.abs().max()))
            log(f"phase 13 step 0 gradients agree per tensor "
                f"(rtol {GRAD_RTOL}, atol {GRAD_RTOL} * max|g_ref|)")
        lk, lr_ = float(loss), float(loss_r)
        if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
            raise AssertionError(f"hybrid step {i}: loss {lk} vs reference {lr_}")
        losses.append((lk, lr_))
    train = counts()
    for k in ("stream_segment_sum", "stream_segment_acc", "bat_segment_sum"):
        if not train[k] or not serve[k]:
            raise AssertionError(f"{k} was not launched on the hybrid path")
    log(f"phase 13 train: {TRAIN_STEPS} steps, losses (hybrid, reference) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses))
    log(f"phase 13 launches: {train} = {TRAIN_STEPS} x (forward {fwd} + backward {bwd})")
    log("phase 13 step wall s: " + ", ".join(f"{t:.4f}" for t in step_s))

    # 14. timings
    arm("hyb_timing")
    fams = []
    x47 = torch.randn(n, c, generator=gen, device=dev)
    for i, sp in enumerate(hyb.stream):
        carry = torch.zeros(sp.n_blocks * sp.s_tile, 128, device=dev)
        carry47 = torch.zeros(sp.n_blocks * sp.s_tile, c, device=dev)
        fam = {"e_tile": sp.e_tile, "tiles": sp.num_tiles, "edges": sp.num_edges,
               "schedule_bytes": schedule_bytes(sp)}
        fam["sum_ms"] = cuda_ms(lambda: stream_segment_sum(sp, x128), iters=10)
        fam["acc_ms"] = cuda_ms(lambda: stream_segment_acc(sp, x128, carry), iters=10)
        fam["sum_f47_ms"] = cuda_ms(lambda: stream_segment_sum(sp, x47), iters=10)
        fam["acc_f47_ms"] = cuda_ms(lambda: stream_segment_acc(sp, x47, carry47), iters=10)
        # device time of the main pass and of the fix-up pass, per mode and F
        for key, fn in (("sum", lambda: stream_segment_sum(sp, x128)),
                        ("acc", lambda: stream_segment_acc(sp, x128, carry)),
                        ("sum_f47", lambda: stream_segment_sum(sp, x47)),
                        ("acc_f47", lambda: stream_segment_acc(sp, x47, carry47))):
            fam[key + "_main_ms"], fam[key + "_fix_ms"] = pass_ms(fn)
        fam["sum_plain_ms"] = cuda_ms(lambda: stream_segment_sum_plain(sp, x128),
                                      iters=3, warmup=1)
        fam["acc_plain_ms"] = cuda_ms(lambda: stream_segment_acc_plain(sp, x128, carry),
                                      iters=3, warmup=1)
        (fam["sum_bound_ms"], fam["sum_bound_by"], nb_s, fam["sum_bound_rows_ms"],
         nr_s) = stream_bound(sp, 128, n, False)
        (fam["acc_bound_ms"], fam["acc_bound_by"], nb_a, fam["acc_bound_rows_ms"],
         nr_a) = stream_bound(sp, 128, n, True)
        fam["sum_f47_bound_ms"] = stream_bound(sp, c, n, False)[0]
        fam["acc_f47_bound_ms"] = stream_bound(sp, c, n, True)[0]
        csr = family_csr(sp, n)
        fam["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x128), iters=10)
        fam["library_f47_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x47), iters=10)
        del csr, carry, carry47
        fams.append(fam)
        log(f"{card} family E={sp.e_tile} ({sp.num_tiles} tiles, {sp.num_edges} edges): "
            f"stream_segment_sum {fam['sum_ms']:.4f} ms (bound {fam['sum_bound_ms']:.4f} ms "
            f"by {fam['sum_bound_by']}: {nb_s / 1e9:.3f} GB), stream_segment_acc "
            f"{fam['acc_ms']:.4f} ms (bound {fam['acc_bound_ms']:.4f} ms: "
            f"{nb_a / 1e9:.3f} GB); plain {fam['sum_plain_ms']:.4f} / "
            f"{fam['acc_plain_ms']:.4f} ms; library torch.sparse.mm (the family's CSR) "
            f"{fam['library_ms']:.4f} ms; the kernel's schedule "
            f"{fam['schedule_bytes'] / 1e9:.3f} GB beside the bound")
        log(f"{card}   bounds side by side: each input once (x blocks once) sum "
            f"{fam['sum_bound_ms']:.4f} ms ({nb_s / 1e9:.3f} GB) / acc {fam['acc_bound_ms']:.4f} "
            f"ms ({nb_a / 1e9:.3f} GB); each live slot's x row once sum "
            f"{fam['sum_bound_rows_ms']:.4f} ms ({nr_s / 1e9:.3f} GB) / acc "
            f"{fam['acc_bound_rows_ms']:.4f} ms ({nr_a / 1e9:.3f} GB)")
        log(f"{card}   F {c}: stream_segment_sum {fam['sum_f47_ms']:.4f} ms (bound "
            f"{fam['sum_f47_bound_ms']:.4f}), stream_segment_acc {fam['acc_f47_ms']:.4f} ms "
            f"(bound {fam['acc_f47_bound_ms']:.4f}); library {fam['library_f47_ms']:.4f} ms")
        log(f"{card}   device ms, main pass + fix-up pass: " + "; ".join(
            f"{key.replace('_f47', f' F {c}')} {fam[key + '_main_ms']:.4f} + "
            f"{fam[key + '_fix_ms']:.4f}" for key in ("sum", "acc", "sum_f47", "acc_f47")))
    # the remainder's bat_segment_sum in both forms (the route runs the
    # gathered one), per direction and width
    rest_timing = {}
    for direction, h in (("forward", hyb), ("transpose", hyb_t)):
        rp = h.rest
        dst_r = rp.dst3.reshape(-1)[: rp.num_edges]
        for xf in (x128, x47):
            rest_timing[f"{direction}_F{xf.shape[1]}"] = bat_timing(
                rp, xf, h.rest_src, dst_r, h.rest_w, card,
                f"{direction} remainder ({rp.num_edges} edges)", plain=False)
    del x47
    adj = torch.sparse_coo_tensor(
        torch.stack([g.dst.long(), g.src.long()]), g.edge_weight, (n, n),
        check_invariants=False).coalesce().to_sparse_csr()
    t_lib = cuda_ms(lambda: torch.sparse.mm(adj, x128), iters=5)
    del adj
    with torch.inference_mode():
        t_spmm = cuda_ms(lambda: api.segment_spmm(g, x128), iters=5)
        t_fwd = cuda_ms(lambda: model(x, g), iters=3, warmup=1)
    t_step = cuda_ms(lambda: step(x, g, y, mask), iters=3, warmup=1)
    log(f"{card} hybrid segment_spmm (F 128, stream families + BAT remainder) {t_spmm:.4f} ms; "
        f"library torch.sparse.mm (whole weighted adjacency, CSR) {t_lib:.4f} ms")
    log(f"{card} hybrid GCN forward (3 layers) {t_fwd:.4f} ms; request wall "
        f"{min(req_s) * 1e3:.4f} ms min")
    log(f"{card} hybrid training step {t_step:.4f} ms; step wall {min(step_s) * 1e3:.4f} ms min")
    faulthandler.cancel_dump_traceback_later()
    rest = fams[1:]
    return {
        "serve": serve, "train": train, "errs": errs, "families": fams,
        "sum": {"ms": fams[0]["sum_ms"], "plain_ms": fams[0]["sum_plain_ms"],
                "bound_ms": fams[0]["sum_bound_ms"], "bound_by": fams[0]["sum_bound_by"],
                "bound_rows_ms": fams[0]["sum_bound_rows_ms"],
                "library_ms": fams[0]["library_ms"]},
        "acc": {"ms": sum(fm["acc_ms"] for fm in rest),
                "plain_ms": sum(fm["acc_plain_ms"] for fm in rest),
                "bound_ms": sum(fm["acc_bound_ms"] for fm in rest),
                "bound_by": rest[0]["acc_bound_by"] if rest else "bytes",
                "bound_rows_ms": sum(fm["acc_bound_rows_ms"] for fm in rest),
                "library_ms": sum(fm["library_ms"] for fm in rest)},
        "spmm_ms": t_spmm, "forward_ms": t_fwd, "train_step_ms": t_step,
        "library_whole_ms": t_lib, "losses": losses, "rest_timing": rest_timing,
    }

def relu_flips(z_kernel, z_ref, what):
    """The hidden pre-activations whose sign differs between the kernel
    path and a reference path: at most FLIP_MAX, each of them within
    FLIP_RTOL * max|z_ref| (of its layer) of 0. Returns (count, the
    largest |z_ref| / max|z_ref| among them)."""
    count, worst = 0, 0.0
    for a, b in zip(z_kernel, z_ref):
        flip = (a > 0) != (b > 0)
        if bool(flip.any()):
            count += int(flip.sum())
            worst = max(worst, float(b[flip].abs().max() / b.abs().max()))
    if count > FLIP_MAX or worst > FLIP_RTOL:
        raise AssertionError(
            f"{what}: {count} hidden pre-activation(s) differ in sign from the reference "
            f"path, the largest at {worst:.3e} * max|z| (allowed: {FLIP_MAX}, within "
            f"{FLIP_RTOL} * max|z|)")
    return count, worst


def slot_csr(plan, w):
    """The plan's slot -> row matrix [n_blocks*s_tile, T*E] in CSR carrying
    the slot weights w (for the library yardstick only)."""
    wf = w.reshape(-1)
    keep = torch.nonzero(wf != 0).reshape(-1)
    rows = plan.dst_slots.reshape(-1).long()[keep]
    return torch.sparse_coo_tensor(
        torch.stack([rows, keep]), wf[keep], (plan.n_blocks * plan.s_tile, wf.numel()),
        check_invariants=False).coalesce().to_sparse_csr()


def slot_bound(plan, w, F):
    """The least time of one slot kernel launch: each real slot's value
    row, every slot's weight, each real slot's dst, out_block, and every
    output row written once (bytes); or 2 f32 flops per real slot and
    column."""
    n_real = int((w != 0).sum())
    n_bytes = (n_real * F * 4 + w.numel() * 4 + n_real * 4 + plan.num_tiles * 4
               + plan.n_blocks * plan.s_tile * F * 4)
    bound, by = bound_ms(n_bytes, 2 * n_real * F)
    return bound, by, n_bytes


def pr_timing(g, n, gen, card):
    """Phase 19's pr timings over GraphSAGE's plan: the mean's degree (ones
    [1, slots] with the mask as weights: the main path's shape), the values
    form at [8, slots] and the gathered form at F 8 (x[src[e]] read in the
    kernel), the old route's [slots, 8] gather and transpose before its
    kernel, the plain versions, the bounds (`slot_bound`; the gathered
    form's `gathered_bound`) and the library yardsticks (torch.sparse.mm
    over the plan's slot -> row CSR; the node CSR for the gathered form).
    Beside each CUDA-event time (back-to-back calls, so the wrapper's host
    work shows where the kernels are shorter), the device time of its
    kernels (torch.profiler: the main pass and the fix-up launches)."""
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import trace

    def device_ms(run, iters=10):
        """(main pass, fix-up launches) device ms per call."""
        _, _, _, events = trace(run, iters, warmup=1)
        return tuple(sum(ev.time_range.elapsed_us() for ev in events if k in ev.name)
                     / 1e3 / iters for k in ("pr_row_kernel", "pr_fix_kernel"))

    plan, w = g.plan, g.plan.mask
    dev = w.device
    slots, n_out = plan.num_tiles * plan.e_tile, plan.n_blocks * plan.s_tile
    fn, pl = sk.plan_segment_sum_pr, ref_ops.plan_segment_sum_pr_plain
    ones = torch.ones(1, slots, device=dev)
    v8 = torch.randn(8, slots, generator=gen, device=dev)
    x8 = torch.randn(n, 8, generator=gen, device=dev)
    csr = slot_csr(plan, w)
    ones_t, v8_t = ones.t().contiguous(), v8.t().contiguous()
    r = {"F": 1, "shape": "the mean's degree: ones [1, slots], the mask as weights"}
    r["ms"] = cuda_ms(lambda: fn(plan, ones, w))
    r["device_main_ms"], r["device_fix_ms"] = device_ms(lambda: fn(plan, ones, w))
    r["plain_ms"] = cuda_ms(lambda: pl(plan, ones, w), iters=3, warmup=1)
    r["bound_ms"], r["bound_by"], nb1 = slot_bound(plan, w, 1)
    r["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, ones_t))
    v = {"ms": cuda_ms(lambda: fn(plan, v8, w)),
         "plain_ms": cuda_ms(lambda: pl(plan, v8, w), iters=3, warmup=1),
         "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, v8_t))}
    v["bound_ms"], v["bound_by"], nb8 = slot_bound(plan, w, 8)
    v["device_main_ms"], v["device_fix_ms"] = device_ms(lambda: fn(plan, v8, w))
    ncsr = node_csr(g.dst, g.src, None, n)
    gt = {"ms": cuda_ms(lambda: fn(plan, x8, w, src=g.src)),
          "plain_ms": cuda_ms(lambda: pl(plan, x8, w, src=g.src), iters=3, warmup=1),
          "library_ms": cuda_ms(lambda: torch.sparse.mm(ncsr, x8)),
          "old_route_gather_ms": cuda_ms(
              lambda: x8.index_select(0, plan.src_slots.reshape(-1)).t().contiguous())}
    gt["bound_ms"], gt["bound_by"], nbg = gathered_bound(n, 8, g.num_edges, True, n_out)
    gt["device_main_ms"], gt["device_fix_ms"] = device_ms(lambda: fn(plan, x8, w, src=g.src))
    r["values_F8"], r["gathered_F8"] = v, gt
    log(f"{card} plan_segment_sum_pr device ms (torch.profiler), main pass + fix-up launches: "
        + "; ".join(f"{k} {d['device_main_ms']:.4f} + {d['device_fix_ms']:.4f}"
                    for k, d in (("the degree", r), ("[8, slots]", v), ("gathered F 8", gt))))
    log(f"{card} plan_segment_sum_pr, the degree [1, slots]: {r['ms']:.4f} ms (bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']}: {nb1 / 1e9:.4f} GB); plain "
        f"{r['plain_ms']:.4f} ms; library torch.sparse.mm (slot -> row CSR) "
        f"{r['library_ms']:.4f} ms || values form [8, slots] {v['ms']:.4f} ms (bound "
        f"{v['bound_ms']:.4f} ms: {nb8 / 1e9:.4f} GB), plain {v['plain_ms']:.4f}, library "
        f"{v['library_ms']:.4f} ms || gathered F 8 (x[src[e]] in the kernel) {gt['ms']:.4f} ms "
        f"(bound {gt['bound_ms']:.4f} ms: {nbg / 1e9:.4f} GB), plain {gt['plain_ms']:.4f}, "
        f"library (node CSR) {gt['library_ms']:.4f} ms; the old route's [slots, 8] gather "
        f"and transpose alone {gt['old_route_gather_ms']:.4f} ms")
    return r


def run_slot(dev, card):
    """Phases 15-19: GraphSAGE and GCN serving and training over the slot
    path on the flickr-shaped graph. Returns the numbers for the kernels
    line."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import build_segment_plan
    from geot_tpu_torch.models import (
        MODELS,
        GCNConv,
        SAGEConv,
        cross_entropy_loss,
        make_optimizer,
        make_train_step,
        prepare_graph,
    )
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum
    from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat
    from geot_tpu_torch.ops.stream_kernels import stream_segment_acc, stream_segment_sum
    from geot_tpu_torch.profile_gcn import FLICKR_HIDDEN, FLICKR_SLOT, trace

    slot_names = ("plan_segment_sum_sr", "plan_segment_sum_sr_packed", "plan_segment_sum_pr")
    counters = {name: getattr(sk, name) for name in slot_names + (
        "plan_segment_sum_mh", "plan_segment_sum_sr2", "plan_segment_sum_packed2")}
    counters.update({"bat_segment_sum": bat_segment_sum, "sddmm_bat": sddmm_bat,
                     "stream_segment_sum": stream_segment_sum,
                     "stream_segment_acc": stream_segment_acc})
    plain = {"plan_segment_sum_sr": ref_ops.plan_segment_sum_sr_plain,
             "plan_segment_sum_sr_packed": ref_ops.plan_segment_sum_sr_packed_plain,
             "plan_segment_sum_pr": ref_ops.plan_segment_sum_pr_plain}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def spmm_sums_in(acc, g, h, reduce="sum"):
        """The reference path's SpMM (`segment_spmm(..., backend="reference")`
        over the graph's own weights) with its gather-scatter sums taken in
        `acc` and cast back. With float64 this is the second oracle of phases
        17-18: in float32 the reference path's sums over the 75 k-edge hub
        row (index_add_, atomics) carry an error of their own (5.6e-4 on the
        GCN's outputs); a whole float64 model would differ from both float32
        paths by the float32 GEMMs over 89 k nodes instead."""
        if g.edge_weight is None:
            out = ref_ops.gather_scatter_ref(g.src, g.dst, h.to(acc), g.num_nodes, reduce)
        else:
            out = ref_ops.gather_weight_scatter_ref(g.src, g.dst, g.edge_weight.to(acc),
                                                    h.to(acc), g.num_nodes, reduce)
        return out.to(h.dtype)

    def conv_sums_in(acc, conv, h, g):
        """One layer of the reference path with `spmm_sums_in(acc, ...)`: a
        GCNConv over a graph with baked weights, or a SAGEConv without the
        output norm, in the parameters' dtype (the two models of this run)."""
        if conv.dtype is not None:
            raise AssertionError("the oracle layers take no compute dtype")
        if isinstance(conv, GCNConv):
            if conv.normalize and g.w_slots is None:
                raise AssertionError("the oracle GCNConv takes the graph's baked norm")
            out = spmm_sums_in(acc, g, conv.lin(h))
            return out if conv.bias is None else out + conv.bias
        if not isinstance(conv, SAGEConv) or conv.normalize:
            raise AssertionError(f"no oracle layer for {conv}")
        out = conv.lin_l(spmm_sums_in(acc, g, h, conv.aggr))
        return out if conv.lin_r is None else out + conv.lin_r(h)

    def forward_masked(m, x, g, masks, acc=None):
        """m's forward pass (dropout off) with the hidden layers' ReLU
        given by `masks` (None: ReLU), through m's own layers or, with
        `acc`, through `conv_sums_in(acc, ...)`; returns (output, the hidden
        layers' pre-activations, detached)."""
        h, zs = x, []
        for i, conv in enumerate(m.convs):
            h = conv(h, g) if acc is None else conv_sums_in(acc, conv, h, g)
            if i < len(m.convs) - 1:
                zs.append(h.detach())
                h = torch.relu(h) if masks is None else h * masks[i]
        return h, zs

    # 15. host build: the graph of bench_models.py, each model's plans
    arm("slot_build")
    n, e, f, c = DATASET_SHAPES["flickr"]
    t0 = time.perf_counter()
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=SEED)
    t_gen = time.perf_counter() - t0
    graphs, models = {}, {}
    for name in ("graphsage", "gcn"):
        cls, loops = MODELS[name]
        t0 = time.perf_counter()
        g = prepare_graph(data.src, data.dst, n, add_self_loops=loops,
                          normalize="gcn" if loops else None, device=dev, **FLICKR_SLOT)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        graphs[name] = g
        p, pt = g.plan, g.plan_t
        deg = torch.bincount(g.dst.long(), minlength=n)
        log(f"phase 15 {name} graph: prepare_graph {t_prep:.2f}s ("
            + ", ".join(f"{k} {v:.2f}s" for k, v in g.build_stats["seconds"].items())
            + f"); {g.num_edges} edges, plan {p.num_tiles} tiles x {p.e_tile} "
            f"({p.num_tiles * p.e_tile} slots, pad {p.padding_ratio:.4f}), {p.n_blocks} "
            f"windows, {len(p.chunks)} chunks; plan_t {pt.num_tiles} tiles; max in-degree "
            f"{int(deg.max())}; largest window {int(torch.bincount(p.out_block.long()).max())} "
            f"tiles")
    log(f"phase 15 generate {t_gen:.2f}s; knobs {FLICKR_SLOT} (the reference table's TPU "
        "picks)")
    gs, gg = graphs["graphsage"], graphs["gcn"]
    routes = (api.dispatch_path(gs, reduce="mean"), api.dispatch_path(gg))
    if routes != ("slot", "slot_static"):
        raise AssertionError(f"dispatch_path {routes}, expected ('slot', 'slot_static')")
    log("phase 15 dispatch_path: GraphSAGE (mean) 'slot', GCN 'slot_static'")

    # 16. each kernel against its plain version on the real plans, both
    # directions, and one plan chunked so that its hub window splits
    arm("slot_kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = {k: 0.0 for k in slot_names}
    n_checks = 0
    cases = [("plan_segment_sum_sr", F, "graphsage", d, False) for F in (f, 128)
             for d in ("plan", "plan_t")]
    cases += [("plan_segment_sum_sr_packed", F, "gcn", d, False) for F in (64, 32, 16, 8, c)
              for d in ("plan", "plan_t")]
    cases += [("plan_segment_sum_sr_packed", 64, "graphsage", d, False)
              for d in ("plan", "plan_t")]
    cases += [("plan_segment_sum_pr", 8, "graphsage", d, False) for d in ("plan", "plan_t")]
    # real edges of weight exactly 0, every third slot: the kernels skip
    # them as they skip pads, so they fall inside the hub row's runs
    cases += [(name, F, "gcn", "plan", True) for name, F in (
        ("plan_segment_sum_sr", 128), ("plan_segment_sum_sr_packed", 64),
        ("plan_segment_sum_sr_packed", 8), ("plan_segment_sum_pr", 8))]
    for name, F, gname, d, zeroed in cases:
        g = graphs[gname]
        plan = getattr(g, d)
        w = (g.w_slots if d == "plan" else g.w_slots_t) if gname == "gcn" else plan.mask
        src_d = g.src if d == "plan" else g.dst_t  # the plan's edge-order src
        if zeroed:
            third = torch.arange(w.numel(), device=dev).reshape(w.shape) % 3 == 1
            w = torch.where(third, torch.zeros_like(w), w)
            d += " with every third slot's weight 0"
        slots = plan.num_tiles * plan.e_tile
        shape = (F, slots) if name == "plan_segment_sum_pr" else (slots, F)
        vals = torch.randn(shape, generator=gen, device=dev)
        # and the gathered form the routes run: x[src[e]] read in the
        # kernel, src the plan's edge-order src
        forms = [("", vals, {}), (" gathered", torch.randn(n, F, generator=gen, device=dev),
                                  {"src": src_d})]
        for form, xv, kw in forms:
            k = counters[name](plan, xv, w, **kw)
            torch.cuda.synchronize()
            p = plain[name](plan, xv, w, **kw)
            a = plain[name](plan, xv.abs(), w.abs(), **kw)
            errs[name] = max(errs[name], check_close_abs_sum(
                k, p, a, f"phase 16 {name}{form} F={F} {gname}.{d}"))
            if not torch.equal(counters[name](plan, xv, w, **kw), k):
                raise AssertionError(f"phase 16 {name}{form} F={F} {gname}.{d}: not "
                                     "deterministic")
            n_checks += 1
        del vals, k, p, a, forms
    # the mean's degree: one pr launch of ones [1, slots] a plan, equal to
    # the in-degree
    for d, deg_of in (("plan", gs.dst), ("plan_t", gs.src)):
        before = sk.plan_segment_sum_pr.launches
        got = api.segment_counts(getattr(gs, d))
        torch.cuda.synchronize()
        expect_launches(sk.plan_segment_sum_pr.launches - before, 1,
                        f"phase 16 segment_counts over graphsage.{d}")
        if not torch.equal(got, torch.bincount(deg_of.long(), minlength=n).float()):
            raise AssertionError(f"phase 16 segment_counts over graphsage.{d}: not the "
                                 "in-degree")
        n_checks += 1
    log(f"phase 16 {n_checks} kernel checks within the abs-sum rule (sr, sr_packed and pr in "
        "both forms; the degree at [1, slots] exact), reruns bit-identical")
    dst_s, src_s = gs.dst.cpu().numpy(), gs.src.cpu().numpy()
    hub_tiles = int(torch.bincount(gs.plan.out_block.long()).max())
    chunk_slots = FLICKR_SLOT["e_tile"] * max(hub_tiles // 3, 2)
    pc = build_segment_plan(dst_s, src_s, n, e_tile=FLICKR_SLOT["e_tile"],
                            s_tile=FLICKR_SLOT["s_tile"], max_chunk_slots=chunk_slots,
                            device=dev)
    split = [c_ for a_, c_ in zip(pc.chunks[:-1], pc.chunks[1:]) if c_[2] < a_[3]]
    if len(pc.chunks) < 3 or not split:
        raise AssertionError("the chunked plan does not split the hub window")
    for name, F in (("plan_segment_sum_sr_packed", 64), ("plan_segment_sum_sr", 128)):
        xf = torch.randn(n, F, generator=gen, device=dev)
        with torch.inference_mode():
            before = counters[name].launches
            got = api._slot_spmm(pc, xf, pc.mask, gs.src)
            torch.cuda.synchronize()
            expect_launches(counters[name].launches - before, 1,
                            f"phase 16 chunked plan: {name} once, the plan whole")
            vals = xf.index_select(0, gs.plan.src_slots.reshape(-1))
            want = ref_ops.plan_segment_sum_sr_plain(gs.plan, vals, gs.plan.mask)[:n]
            a = ref_ops.plan_segment_sum_sr_plain(gs.plan, vals.abs(), gs.plan.mask)[:n]
        errs[name] = max(errs[name], check_close_abs_sum(
            got, want, a, f"phase 16 chunked plan ({len(pc.chunks)} uniform chunks of "
            f"{chunk_slots} slots, hub window split {len(split)} time(s)) {name} F={F}"))
        del got, want, a, vals, xf
    # pr over the chunked plan (out_block out of order as a whole), the
    # plan whole: the gathered form at F 8 and the degree
    name = "plan_segment_sum_pr"
    x8 = torch.randn(n, 8, generator=gen, device=dev)
    before = sk.plan_segment_sum_pr.launches
    got = sk.plan_segment_sum_pr(pc, x8, pc.mask, src=gs.src)[:, :n]
    deg = api.segment_counts(pc)
    torch.cuda.synchronize()
    expect_launches(sk.plan_segment_sum_pr.launches - before, 2,
                    "phase 16 chunked plan: pr and the degree, each the plan whole")
    want = ref_ops.plan_segment_sum_pr_plain(gs.plan, x8, gs.plan.mask, src=gs.src)[:, :n]
    a = ref_ops.plan_segment_sum_pr_plain(gs.plan, x8.abs(), gs.plan.mask, src=gs.src)[:, :n]
    errs[name] = max(errs[name], check_close_abs_sum(
        got, want, a, f"phase 16 chunked plan ({len(pc.chunks)} chunks) {name} F=8 gathered"))
    if not torch.equal(deg, torch.bincount(gs.dst.long(), minlength=n).float()):
        raise AssertionError("phase 16 chunked plan: segment_counts is not the in-degree")
    del pc, got, want, a, x8, deg

    # 17. serve: 5 requests per model, each against the reference path
    arm("slot_serve")
    x = torch.from_numpy(data.x).to(dev)
    per_request = {"graphsage": {"plan_segment_sum_sr": 1, "plan_segment_sum_sr_packed": 2,
                                 "plan_segment_sum_pr": 3},
                   "gcn": {"plan_segment_sum_sr_packed": 3}}
    per_step = {"graphsage": {"plan_segment_sum_sr": 1, "plan_segment_sum_sr_packed": 4,
                              "plan_segment_sum_pr": 3},
                "gcn": {"plan_segment_sum_sr_packed": 6}}
    serve, train, req_s, step_s, ref_models = {}, {}, {}, {}, {}
    for name in ("graphsage", "gcn"):
        cls, _ = MODELS[name]
        g = graphs[name]
        model = cls(f, FLICKR_HIDDEN, 3, c, generator=torch.Generator().manual_seed(SEED),
                    device=dev).eval()
        ref_model = cls(f, FLICKR_HIDDEN, 3, c, backend="reference", device=dev).eval()
        ref_model.load_state_dict(model.state_dict())
        models[name], ref_models[name] = model, ref_model
        want = {k: per_request[name].get(k, 0) for k in counters}
        outs, req_s[name] = [], []
        reset()  # count this model's serving launches only
        with torch.inference_mode():
            for i in range(REQUESTS):
                before = counts()
                ts = time.perf_counter()
                out = model(x, g)
                torch.cuda.synchronize()
                req_s[name].append(time.perf_counter() - ts)
                expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                                f"{name} request {i}")
                outs.append(out)
            serve[name] = counts()
            ref = ref_model(x, g)
            oracle, _ = forward_masked(ref_model, x, g, None, torch.float64)
            # the oracle's layers are the reference model's, but for the sums
            torch.testing.assert_close(forward_masked(ref_model, x, g, None, torch.float32)[0],
                                       ref, **MODEL_TOL)
        for i, out in enumerate(outs):
            if out.shape != (n, c) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} request {i}: bad output {tuple(out.shape)}")
            torch.testing.assert_close(out, ref, **MODEL_TOL)
        log(f"phase 17 {name}: {REQUESTS} requests, launches {serve[name]} (per request "
            f"{per_request[name]}); outputs [{n}, {c}] finite, max |kernel path - reference "
            f"path| = {float((outs[0] - ref).abs().max()):.3e} (tolerance {MODEL_TOL}); "
            f"against the reference path with float64 sums: kernel path "
            f"{float((outs[0] - oracle).abs().max()):.3e}, float32 reference path "
            f"{float((ref - oracle).abs().max()):.3e}; request s: "
            + ", ".join(f"{t:.4f}" for t in req_s[name]))
        del outs, ref, out, oracle

    # 18. train: 5 AdamW steps per model beside the reference path
    arm("slot_train")
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    steps, losses = {}, {}
    for name in ("graphsage", "gcn"):
        model, ref_model, g = models[name], ref_models[name], graphs[name]
        step = make_train_step(model, make_optimizer(model, LR, WEIGHT_DECAY),
                               has_dropout=False)
        ref_step = make_train_step(ref_model, make_optimizer(ref_model, LR, WEIGHT_DECAY),
                                   has_dropout=False)
        steps[name] = step
        # the step-0 gradients of the reference path (float32, and with its
        # sums in float64), from the same parameters and through the kernel
        # path's own ReLU pattern: a pre-activation within rounding of 0 may
        # take the other sign on the other path (one of the 11.4 M hidden
        # pre-activations of GraphSAGE does, at ~1e-7), and relu' then
        # differs there by the whole upstream gradient. relu_flips holds
        # such sign flips to a few, each at rounding scale.
        with torch.no_grad():
            _, z_kernel = forward_masked(model, x, g, None)
        relu_masks = [z > 0 for z in z_kernel]
        g_ref_masked, flips = {}, {}
        for tag, acc in (("f32", None), ("f64", torch.float64)):
            ref_model.zero_grad(set_to_none=True)
            out_o, z_ref = forward_masked(ref_model, x, g, relu_masks, acc)
            cross_entropy_loss(out_o, y, mask).backward()
            g_ref_masked[tag] = {k: prm.grad for k, prm in ref_model.named_parameters()}
            flips[tag] = relu_flips(z_kernel, z_ref, f"phase 18 {name} ({tag} reference)")
        ref_model.zero_grad(set_to_none=True)
        del out_o, z_kernel, z_ref, relu_masks
        want = {k: per_step[name].get(k, 0) for k in counters}
        losses[name], step_s[name] = [], []
        reset()  # count this model's training launches only
        for i in range(TRAIN_STEPS):
            before = counts()
            ts = time.perf_counter()
            loss = step(x, g, y, mask)
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - ts)
            expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                            f"{name} step {i}")
            loss_r = ref_step(x, g, y, mask)
            if i == 0:
                pr = dict(ref_model.named_parameters())
                excess = []
                for pname, prm in model.named_parameters():
                    ratios = []
                    for gr in (g_ref_masked["f32"][pname], g_ref_masked["f64"][pname]):
                        lim = GRAD_RTOL * gr.abs() + GRAD_RTOL * float(gr.abs().max())
                        ratios.append(float(((prm.grad - gr).abs() / lim).max()))
                        torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                                   atol=GRAD_RTOL * float(gr.abs().max()))
                    gr = g_ref_masked["f64"][pname]
                    lim = GRAD_RTOL * gr.abs() + GRAD_RTOL * float(gr.abs().max())
                    ratios.append(float(((pr[pname].grad - gr).abs() / lim).max()))
                    excess.append((pname, *ratios))
                log(f"phase 18 {name} step 0 gradients through the kernel path's ReLU "
                    "pattern (hidden pre-activations of the kernel path that differ in sign "
                    "from the float32 reference path / the reference path with float64 sums: "
                    + ", ".join(f"{k_} {n_}, the largest |z_ref| {w_:.3e} * max|z_ref|"
                                for k_, (n_, w_) in flips.items())
                    + f"; allowed {FLIP_MAX}, within {FLIP_RTOL} * max|z_ref|), max |err| / "
                    "(rtol |g| + atol) per "
                    "tensor (kernel path vs the float32 reference path, kernel path vs the "
                    "reference path with float64 sums, the float32 reference path with its "
                    "own ReLU pattern vs the latter): "
                    + ", ".join(f"{k} ({a:.3f}, {b:.3f}, {c:.3f})" for k, a, b, c in excess))
            lk, lr_ = float(loss), float(loss_r)
            if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
                raise AssertionError(f"{name} step {i}: loss {lk} vs reference {lr_}")
            losses[name].append((lk, lr_))
        train[name] = counts()
        log(f"phase 18 {name}: step 0 gradients agree per tensor with the reference path "
            f"through the kernel path's ReLU pattern, in float32 and with float64 sums "
            f"(rtol {GRAD_RTOL}, atol {GRAD_RTOL} * max|g_ref|); {TRAIN_STEPS} steps, losses (kernel, reference) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses[name])
            + f"; launches {train[name]} (per step {per_step[name]}); step wall s: "
            + ", ".join(f"{t:.4f}" for t in step_s[name]))
    for k in slot_names:
        if not serve["graphsage"][k] or not train["graphsage"][k]:
            raise AssertionError(f"{k} was not launched on the slot path")
    del ref_models

    # 19. timings: each kernel at its main-path shape, the slot SpMM per
    # layer width, forward and training step per model, busy share
    arm("slot_timing")
    timing = {}
    shapes = [("plan_segment_sum_sr", gs, gs.plan.mask, f),
              ("plan_segment_sum_sr_packed", gg, gg.w_slots, FLICKR_HIDDEN),
              ("plan_segment_sum_sr_packed", gg, gg.w_slots, c)]
    for name, g, w, F in shapes:
        plan = g.plan
        slots = plan.num_tiles * plan.e_tile
        vals = torch.randn(slots, F, generator=gen, device=dev)
        fn, pl = counters[name], plain[name]
        t_k = cuda_ms(lambda: fn(plan, vals, w))
        t_p = cuda_ms(lambda: pl(plan, vals, w), iters=3, warmup=1)
        csr = slot_csr(plan, w)
        t_lib = cuda_ms(lambda: torch.sparse.mm(csr, vals))
        bound, by, nb = slot_bound(plan, w, F)
        timing[(name, F)] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                             "library_ms": t_lib}
        log(f"{card} {name} F={F}: kernel {t_k:.4f} ms (bound {bound:.4f} ms by {by}: "
            f"{nb / 1e9:.4f} GB); plain {t_p:.4f} ms; library torch.sparse.mm (the plan's "
            f"slot -> row CSR with its slot weights) {t_lib:.4f} ms")
        del vals, csr
        # the gathered form the route runs (x[src[e]] in the kernel), with
        # the [slots, F] gather it replaces; the values form above
        xg = torch.randn(n, F, generator=gen, device=dev)
        t_g = cuda_ms(lambda: fn(plan, xg, w, src=g.src))
        t_pg = cuda_ms(lambda: pl(plan, xg, w, src=g.src), iters=3, warmup=1)
        t_gather = cuda_ms(lambda: xg.index_select(0, plan.src_slots.reshape(-1)))
        ncsr = node_csr(g.dst, g.src, g.edge_weight, n)
        t_libg = cuda_ms(lambda: torch.sparse.mm(ncsr, xg))
        n_out = plan.n_blocks * plan.s_tile
        bound_g, by_g, nb_g = gathered_bound(n, F, g.num_edges, True, n_out)
        rows_ms, _, nb_r = edge_rows_bound(int((w != 0).sum()), F, g.num_edges, 4, n_out)
        timing[(name, F)] = {"ms": t_g, "plain_ms": t_pg, "bound_ms": bound_g,
                             "bound_by": by_g, "library_ms": t_libg,
                             "rows_bound_ms": rows_ms,
                             "form": "gathered (x[src[e]] read in the kernel)",
                             "values_form": dict(timing[(name, F)], gather_ms=t_gather)}
        log(f"{card} {name} F={F} gathered (x[src[e]] in the kernel): {t_g:.4f} ms "
            f"(bound {bound_g:.4f} ms by {by_g}: {nb_g / 1e9:.4f} GB, x's rows once; "
            f"{rows_ms:.4f} ms with each live edge's row once: {nb_r / 1e9:.4f} GB); "
            f"plain {t_pg:.4f} ms; library torch.sparse.mm (the node CSR) {t_libg:.4f} ms; "
            f"the [slots, F] gather alone {t_gather:.4f} ms")
        del xg, ncsr
    timing[("plan_segment_sum_pr", 1)] = pr_timing(gs, n, gen, card)
    spmm = {}
    with torch.inference_mode():
        for F, g, w in ((f, gs, gs.plan.mask), (FLICKR_HIDDEN, gg, gg.w_slots), (c, gg, gg.w_slots)):
            xf = torch.randn(n, F, generator=gen, device=dev)
            spmm[F] = cuda_ms(lambda: api._slot_spmm(g.plan, xf, w, g.src))
            log(f"{card} slot SpMM F={F} (x[src[e]] read in the kernel): {spmm[F]:.4f} ms")
    fwd, stp, busy = {}, {}, {}
    for name in ("graphsage", "gcn"):
        model, g = models[name], graphs[name]
        model.eval()
        with torch.inference_mode():
            fwd[name] = cuda_ms(lambda: model(x, g), iters=10)
        stp[name] = cuda_ms(lambda: steps[name](x, g, y, mask), iters=5, warmup=2)

        def serve_once():
            model.eval()
            with torch.inference_mode():
                model(x, g)

        for mode, run in (("serve", serve_once), ("train", lambda: steps[name](x, g, y, mask))):
            prof, wall_us, busy_us, events = trace(run, 3)
            top = sorted(prof.key_averages(), key=lambda ev: -ev.self_device_time_total)[:6]
            busy[(name, mode)] = busy_us / max(wall_us, 1e-9)
            log(f"{card} {name} {mode} x3: traced wall {wall_us / 1e3:.4f} ms, device "
                f"{busy_us / 1e3:.4f} ms, busy share {busy[(name, mode)]:.4f}; top device "
                "time: " + "; ".join(f"{ev.key[:48]} {ev.self_device_time_total / 1e3:.4f} ms "
                                     f"x{ev.count}" for ev in top))
        log(f"{card} {name}: forward {fwd[name]:.4f} ms (request wall "
            f"{min(req_s[name]) * 1e3:.4f} ms min); training step {stp[name]:.4f} ms (step "
            f"wall {min(step_s[name]) * 1e3:.4f} ms min)")
    faulthandler.cancel_dump_traceback_later()
    return {"serve": serve, "train": train, "errs": errs, "timing": timing, "spmm_ms": spmm,
            "forward_ms": fwd, "train_step_ms": stp, "busy": busy, "losses": losses}


def aeb_csr(plan, w_slots, w_edge):
    """The edge -> row matrix of an AEB sum over edge-order values in CSR,
    with the weights the kernel applies (w_slots times w_edge[e0 + j]).
    For the library yardstick only."""
    E = plan.e_tile
    edge = (plan.e0.long()[:, None] + torch.arange(E, device=plan.e0.device)).reshape(-1)
    w = w_slots.reshape(-1).clone()
    live = torch.nonzero(w != 0).reshape(-1)
    if w_edge is not None:
        w[live] = w[live] * w_edge[edge[live]]
    keep = torch.nonzero(w != 0).reshape(-1)
    rows = plan.dst_slots.reshape(-1).long()[keep]
    return torch.sparse_coo_tensor(
        torch.stack([rows, edge[keep]]), w[keep], (plan.n_blocks * plan.s_tile, plan.num_edges),
        check_invariants=False).coalesce().to_sparse_csr()


def aeb_bound(plan, w_slots, w_edge, F):
    """The least time of one AEB launch: each live slot's value row, weight
    in edge order and dst, every slot's static weight or mask, e0 and
    out_block, and every output row written once (bytes); or 2 f32 flops
    per live slot and column."""
    n_live = int((w_slots != 0).sum())
    n_bytes = (n_live * F * 4 + w_slots.numel() * 4 + n_live * 4 + 2 * plan.num_tiles * 4
               + plan.n_blocks * plan.s_tile * F * 4)
    if w_edge is not None:
        n_bytes += n_live * 4
    bound, by = bound_ms(n_bytes, 2 * n_live * F)
    return bound, by, n_bytes


def node_csr(dst, src, w, n):
    """The node adjacency [n, n] in CSR with weights w (ones where None):
    the whole SpMM out = A @ x, sum_e w_e x[src_e] into row dst_e. For the
    library yardstick of the gathered form only."""
    vals = torch.ones(dst.shape[0], device=dst.device) if w is None else w
    return torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]), vals, (n, n),
                                   check_invariants=False).coalesce().to_sparse_csr()


def edge_rows_bound(n_live, F, nnz, w_bytes, n_out):
    """The least time of the gathered form with each live edge's x row
    counted once (the row reads the kernel issues, which `gathered_bound`
    counts once per node): those rows, src and w_bytes of weights per edge,
    and every output row written once (bytes); or 2 f32 flops per live
    edge and column."""
    n_bytes = n_live * F * 4 + nnz * (4 + w_bytes) + n_out * F * 4
    bound, by = bound_ms(n_bytes, 2 * n_live * F)
    return bound, by, n_bytes


def gathered_bound(n_rows, F, nnz, weighted, n_out):
    """The least time of the gathered form (edge e reads x[src[e]] in the
    kernel): x's rows once, src and the weights in edge order, and every
    output row written once (bytes); or its f32 flops, 2 per edge and
    column weighted, 1 unweighted."""
    n_bytes = n_rows * F * 4 + nnz * 4 + (nnz * 4 if weighted else 0) + n_out * F * 4
    bound, by = bound_ms(n_bytes, (2 if weighted else 1) * nnz * F)
    return bound, by, n_bytes


def mh_csr(plan, w_heads):
    """The mh sum as one sparse matrix: over vals [S, H*D] viewed as
    [S*H, D], the CSR [rows*H, S*H] with entry (dst(s)*H + h, s*H + h) =
    w_heads[s, h] gives the output [rows, H*D] viewed as [rows*H, D] in one
    torch.sparse.mm. For the library yardstick only."""
    S, H = w_heads.shape
    wf = w_heads.reshape(-1)
    keep = torch.nonzero(wf != 0).reshape(-1)
    s_, h_ = keep // H, keep % H
    rows = plan.dst_slots.reshape(-1).long()[s_] * H + h_
    return torch.sparse_coo_tensor(
        torch.stack([rows, keep]), wf[keep], (plan.n_blocks * plan.s_tile * H, S * H),
        check_invariants=False).coalesce().to_sparse_csr()


def mh_node_csr(dst, src, w_heads, n):
    """The multi-head SpMM as one sparse matrix over node rows: x [n, H*D]
    viewed as [n*H, D], the CSR [n*H, n*H] with entry (dst_e*H + h, src_e*H
    + h) = w_heads[e, h]. For the library yardstick only."""
    H = w_heads.shape[1]
    h = torch.arange(H, device=dst.device)
    rows = (dst.long()[:, None] * H + h).reshape(-1)
    cols = (src.long()[:, None] * H + h).reshape(-1)
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), w_heads.reshape(-1),
                                   (n * H, n * H), check_invariants=False
                                   ).coalesce().to_sparse_csr()


def mh_bound(plan, w_heads, F):
    """The least time of one mh launch: each live slot's value row and dst,
    every slot's head weights, out_block, and every output row written
    once (bytes); or 2 f32 flops per live slot and column."""
    n_live = int((w_heads != 0).any(dim=1).sum())
    n_bytes = (n_live * F * 4 + w_heads.numel() * 4 + n_live * 4 + plan.num_tiles * 4
               + plan.n_blocks * plan.s_tile * F * 4)
    bound, by = bound_ms(n_bytes, 2 * n_live * F)
    return bound, by, n_bytes


def run_gat_dyn(dev, card):
    """Phases 20-24: GAT (4 heads averaged, hidden 64) and GCN with
    per-call weights over the slot plans (slot_dyn, feature_hint 64 and
    128), serving and training on the flickr-shaped graph. Returns the
    numbers for the kernels line."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import build_segment_plan
    from geot_tpu_torch.graph.structures import build_graph
    from geot_tpu_torch.models import (
        GAT,
        GCN,
        cross_entropy_loss,
        make_optimizer,
        make_train_step,
    )
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum
    from geot_tpu_torch.ops.sddmm_kernels import edge_dots, edge_dots_plain, sddmm_bat
    from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad
    from geot_tpu_torch.ops.stream_kernels import stream_segment_acc, stream_segment_sum
    from geot_tpu_torch.profile_gcn import FLICKR_GAT, FLICKR_HIDDEN, flickr_graph, trace

    new = ("plan_segment_sum_mh", "plan_segment_sum_sr2", "plan_segment_sum_packed2")
    counters = {k: getattr(sk, k) for k in new + (
        "plan_segment_sum_sr", "plan_segment_sum_sr_packed", "plan_segment_sum_pr")}
    counters.update({"bat_segment_sum": bat_segment_sum, "sddmm_bat": sddmm_bat,
                     "edge_dots": edge_dots, "stream_segment_sum": stream_segment_sum,
                     "stream_segment_acc": stream_segment_acc, "edge_softmax": edge_softmax,
                     "edge_softmax_grad": edge_softmax_grad})

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def forward_masked(m, x, g, masks):
        """m's forward pass with the hidden layers' ReLU given by `masks`
        (None: ReLU); returns (output, the hidden pre-activations)."""
        h, zs = x, []
        for i, conv in enumerate(m.convs):
            h = conv(h, g)
            if i < len(m.convs) - 1:
                zs.append(h.detach())
                h = torch.relu(h) if masks is None else h * masks[i].to(h.dtype)
        return h, zs

    # 20. host build: the flickr graph with self-loops, for GAT and for the
    # per-call-weight GCN at feature_hint 64 and 128
    arm("gat_build")
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=SEED)
    graphs = {}
    for name, kind, fh in (("gat", "gat", 128), ("gcn_dyn64", "gcn-dyn", 64),
                           ("gcn_dyn128", "gcn-dyn", 128)):
        t0 = time.perf_counter()
        g = flickr_graph(data, kind, dev, fh)
        torch.cuda.synchronize()
        graphs[name] = g
        p = g.plan
        log(f"phase 20 {name} graph: prepare_graph {time.perf_counter() - t0:.2f}s; "
            f"{g.num_edges} edges, plan {p.num_tiles} tiles x {p.e_tile} ({p.num_tiles * p.e_tile} "
            f"slots), pack_align {p.pack_align}, {p.n_blocks} windows, {len(p.chunks)} chunks; "
            f"plan_t {g.plan_t.num_tiles} tiles")
    gg, g64, g128 = graphs["gat"], graphs["gcn_dyn64"], graphs["gcn_dyn128"]
    routes = (api.dispatch_path(g64, dynamic_w=True), api.dispatch_path(g128, dynamic_w=True))
    if routes != ("slot_dyn", "slot_dyn"):
        raise AssertionError(f"dispatch_path of the per-call weights {routes}, expected slot_dyn")
    packed = (api._aeb_packed_ok(g64.plan, FLICKR_HIDDEN), api._aeb_packed_ok(g64.plan, c),
              api._aeb_packed_ok(g128.plan, FLICKR_HIDDEN))
    if packed != (64, 8, 0):
        raise AssertionError(f"AEB kernel names {packed}, expected packed2 at F 64 and {c} on "
                             "the pack-aligned plan, sr2 on the other")
    if gg.plan is None or gg.num_edges > api.GAT_FUSED_MAX_EDGES:
        raise AssertionError("the GAT graph has no slot plan or does not name the fused route")
    log(f"phase 20 dispatch_path: per-call weights 'slot_dyn' on both GCN graphs (one route, "
        f"the AEB function reading x[src[e]] in the edge-row kernel, launched as the reference "
        f"names it: packed2 at F 64 and {c} with pack_align 16, sr2 with pack_align 1); GAT's "
        f"route named fused ({gg.num_edges} edges <= fused_max_edges "
        f"{api.GAT_FUSED_MAX_EDGES}), one computation with the composed route on the card")
    for name in ("gcn_dyn64", "gcn_dyn128"):
        st = graphs[name].build_stats["row_schedule"]
        log(f"phase 20 {name} edge-row schedules (host build, bytes on the card): "
            + ", ".join(f"{d} {v['seconds']:.3f}s {v['bytes'] / 1e6:.2f} MB"
                        for d, v in st.items()))
    # build_graph with its default layouts, the reference's ("bat", "slot",
    # "stream"; ROADMAP C.13), on the same edges
    t0 = time.perf_counter()
    gdef = build_graph(data.src, data.dst, n, device=dev)
    torch.cuda.synchronize()
    fams = {k: getattr(gdef, k) is not None for k in ("bat", "plan", "hyb")}
    if not (fams["bat"] and fams["plan"]):
        raise AssertionError(f"build_graph's defaults built {fams}: expected BAT and slot plans")
    log(f"phase 20 build_graph defaults (layouts {('bat', 'slot', 'stream')}, the reference's): "
        f"{time.perf_counter() - t0:.2f}s, {gdef.num_edges} edges; families {fams} (the "
        f"stream census, forward: stream share "
        f"{gdef.build_stats['stream'].get('forward', {}).get('stream_frac', 0.0):.3f}); "
        f"dispatch_path no weights {api.dispatch_path(gdef)!r}, per-call weights "
        f"{api.dispatch_path(gdef, dynamic_w=True)!r}; edge-row schedules "
        + ", ".join(f"{d} {v['bytes'] / 1e6:.2f} MB" for d, v in
                    gdef.build_stats["row_schedule"].items()))
    del gdef

    # 21. each new kernel against its plain version on both directions'
    # real plans, with exact-zero weights, and on a chunked plan
    arm("gat_kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    errs = {k: 0.0 for k in new + ("edge_dots",)}

    def held(name, k, p, a, what, rerun):
        errs[name] = max(errs[name], check_close_abs_sum(k, p, a, f"phase 21 {name} {what}"))
        if not torch.equal(rerun(), k):
            raise AssertionError(f"phase 21 {name} {what}: not deterministic")

    n_checks = 0
    for d in ("plan", "plan_t"):
        plan = getattr(gg, d)
        src_d = gg.src if d == "plan" else gg.dst_t  # the plan's edge-order src
        nnz, mask = gg.num_edges, plan.mask.reshape(-1, 1)
        edge_pos = plan.edge_pos.reshape(-1).long()
        for H, D in ((4, 64), (4, 7), (3, 96), (8, 32)):
            xh = torch.randn(n, H * D, generator=gen, device=dev)
            vals = xh.index_select(0, plan.src_slots.reshape(-1))
            wh = torch.rand(nnz, H, generator=gen, device=dev)
            for zeroed in (False, True):
                w = wh
                if zeroed:  # heads 0 and 2 exactly 0 on every third edge, all on every 7th
                    edge = torch.arange(nnz, device=dev)[:, None]
                    w = torch.where((edge % 3 == 1) & (torch.arange(H, device=dev) % 2 == 0)
                                    | (edge % 7 == 3), 0.0, wh)
                w_slots = (w.index_select(0, edge_pos) * mask).contiguous()
                # the values form (slot order, the TPU kernel's contract) and
                # the gathered one the routes run (x[src[e]], edge-order weights)
                for form, v, w_, kw in (("values", vals, w_slots, {}),
                                        ("gathered", xh, w, {"src": src_d})):
                    k = sk.plan_segment_sum_mh(plan, v, w_, D, **kw)
                    torch.cuda.synchronize()
                    held("plan_segment_sum_mh", k,
                         ref_ops.plan_segment_sum_mh_plain(plan, v, w_, D, **kw),
                         ref_ops.plan_segment_sum_mh_plain(plan, v.abs(), w_, D, **kw),
                         f"(H, D) = ({H}, {D}) gat.{d} {form}" + (" zero heads" if zeroed else ""),
                         lambda: sk.plan_segment_sum_mh(plan, v, w_, D, **kw))
                    n_checks += 1
            del xh, vals, wh, w, w_slots, k
    for gname, g in (("gcn_dyn128", g128), ("gcn_dyn64", g64)):
        for d in ("plan", "plan_t"):
            plan = getattr(g, d)
            S, nnz = plan.num_tiles * plan.e_tile, g.num_edges
            we = torch.rand(nnz, generator=gen, device=dev) + 0.1
            we_zero = torch.where(torch.arange(nnz, device=dev) % 3 == 1, 0.0, we)
            ws = plan.mask * torch.randn(plan.mask.shape, generator=gen, device=dev)
            cases = []
            # the gathered form: edge e reads x[src[e]] (plan: the graph's
            # src; plan_t: its dst in src-sorted order)
            src_d = g.src if d == "plan" else g.dst_t
            if gname == "gcn_dyn128":
                for F in (f, 128, 64):
                    cases += [("slot", F, None, we), ("slot", F, None, we_zero),
                              ("edge", F, ws, None), ("edge", F, None, we), ("edge", F, ws, we)]
                cases += [("gathered", F, None, w_) for F in (128, 64, c)
                          for w_ in (we, we_zero)]
            else:
                cases += [(lay, F, None, w_) for lay in ("packed2", "packed2 gathered")
                          for F in (64, 32, 16, 8, c) for w_ in (we, we_zero)]
            for layout, F, w_s, w_e in cases:
                gathered = layout.endswith("gathered")
                rows = n if gathered else S if layout == "slot" else nnz
                vals = torch.randn(rows, F, generator=gen, device=dev)
                abs_kw = dict(w_slots=None if w_s is None else w_s.abs(),
                              w_edge=None if w_e is None else w_e.abs())
                what = (f"F={F} {gname}.{d} {layout} values, "
                        + ("static" if w_s is not None else "mask")
                        + (" x per-call" if w_e is not None else "") + " weights"
                        + (" (every third 0)" if w_e is we_zero else ""))
                extra = {"src": src_d} if gathered else {}
                if layout.startswith("packed2"):
                    name, fn = "plan_segment_sum_packed2", sk.plan_segment_sum_packed2
                    pl = ref_ops.plan_segment_sum_packed2_plain
                    kw = dict(w_slots=w_s, w_edge=w_e, **extra)
                else:
                    name, fn = "plan_segment_sum_sr2", sk.plan_segment_sum_sr2
                    pl = ref_ops.plan_segment_sum_sr2_plain
                    lay = "edge" if gathered else layout
                    kw = dict(vals_layout=lay, w_slots=w_s, w_edge=w_e, **extra)
                    abs_kw["vals_layout"] = lay
                abs_kw.update(extra)
                k = fn(plan, vals, **kw)
                torch.cuda.synchronize()
                held(name, k, pl(plan, vals, **kw), pl(plan, vals.abs(), **abs_kw), what,
                     lambda: fn(plan, vals, **kw))
                n_checks += 1
                del vals, k
    # the per-edge, per-head dot of GAT's attention gradient (edge_dots) at
    # its two layer shapes, over GAT's dst-sorted edges: a[dst[e]] and
    # b[src[e]] read in the kernel (the route's form), and b in edge order
    for H, D in ((4, FLICKR_HIDDEN), (4, c)):
        a_ = torch.randn(n, H * D, generator=gen, device=dev)
        b_ = torch.randn(n, H * D, generator=gen, device=dev)
        for form, bb, s_ in (("gathered", b_, gg.src),
                             ("values", b_.index_select(0, gg.src.long()), None)):
            k = edge_dots(a_, bb, gg.dst, s_, D)
            torch.cuda.synchronize()
            held("edge_dots", k, edge_dots_plain(a_, bb, gg.dst, s_, D),
                 edge_dots_plain(a_.abs(), bb.abs(), gg.dst, s_, D),
                 f"(H, D) = ({H}, {D}) {form}", lambda: edge_dots(a_, bb, gg.dst, s_, D))
            n_checks += 1
        del a_, b_, bb, k
    # a plan chunked so that its hub window splits: the slot_dyn sums (both
    # AEB routes) and mh, each the whole plan in one launch, against the
    # unchunked plain sums
    dst_s, src_s = g64.dst.cpu().numpy(), g64.src.cpu().numpy()
    hub_tiles = int(torch.bincount(g64.plan.out_block.long()).max())
    for name, fh, F in (("plan_segment_sum_packed2", 64, 64),
                        ("plan_segment_sum_sr2", 128, 64), ("plan_segment_sum_mh", 128, 256)):
        pc = build_segment_plan(dst_s, src_s, n, e_tile=512, s_tile=256,
                                pack_align=16 if fh == 64 else 1,
                                max_chunk_slots=512 * max(hub_tiles // 3, 2), device=dev)
        whole = g64.plan if fh == 64 else g128.plan
        split = [b for a, b in zip(pc.chunks[:-1], pc.chunks[1:]) if b[2] < a[3]]
        if len(pc.chunks) < 3 or not split:
            raise AssertionError("the chunked plan does not split the hub window")
        xf = torch.randn(n, F, generator=gen, device=dev)
        with torch.inference_mode():
            if name == "plan_segment_sum_mh":
                wh = torch.rand(g64.num_edges, 4, generator=gen, device=dev)
                before = sk.plan_segment_sum_mh.launches
                got = api._mh_fwd(pc, xf.reshape(n, 4, 64), wh, g64.src).reshape(n, F)
                expect_launches(sk.plan_segment_sum_mh.launches - before, 1,
                                "phase 21 mh route on a chunked plan (summed whole)")
                vals = xf.index_select(0, whole.src_slots.reshape(-1))
                wsl = wh.index_select(0, whole.edge_pos.reshape(-1)) * whole.mask.reshape(-1, 1)
                want = ref_ops.plan_segment_sum_mh_plain(whole, vals, wsl, 64)[:n]
                a = ref_ops.plan_segment_sum_mh_plain(whole, vals.abs(), wsl, 64)[:n]
            else:
                we = torch.rand(g64.num_edges, generator=gen, device=dev)
                before = getattr(sk, name).launches
                got = api._spmm_fwd_slot_dyn(pc, xf, we, g64.src)
                expect_launches(getattr(sk, name).launches - before, 1,
                                f"phase 21 {name} route on a chunked plan (summed whole)")
                vals = xf.index_select(0, g64.src.long())
                want = ref_ops.plan_segment_sum_sr2_plain(whole, vals, vals_layout="edge",
                                                          w_edge=we)[:n]
                a = ref_ops.plan_segment_sum_sr2_plain(whole, vals.abs(), vals_layout="edge",
                                                       w_edge=we)[:n]
        errs[name] = max(errs[name], check_close_abs_sum(
            got, want, a, f"phase 21 {name} through its route on a chunked plan "
            f"({len(pc.chunks)} uniform chunks, hub window split {len(split)} time(s)) F={F}"))
        n_checks += 1
        del pc, got, want, a, vals, xf
    log(f"phase 21 {n_checks} kernel checks within the abs-sum rule, reruns bit-identical")

    # 22. serve: 5 requests per model, each against the reference path in
    # float64 (sums and all)
    arm("gat_serve")
    x = torch.from_numpy(data.x).to(dev)
    mk = {"gat": lambda **kw: GAT(f, FLICKR_HIDDEN, 3, c, conv_kwargs=FLICKR_GAT, **kw),
          "gcn_dyn64": lambda **kw: GCN(f, FLICKR_HIDDEN, 3, c, **kw),
          "gcn_dyn128": lambda **kw: GCN(f, FLICKR_HIDDEN, 3, c, **kw)}
    per_request = {"gat": {"plan_segment_sum_mh": 3, "edge_softmax": 3},
                   "gcn_dyn64": {"plan_segment_sum_packed2": 3},
                   "gcn_dyn128": {"plan_segment_sum_sr2": 3}}
    per_step = {"gat": {"plan_segment_sum_mh": 6, "edge_dots": 3, "edge_softmax": 3,
                        "edge_softmax_grad": 3},
                "gcn_dyn64": {"plan_segment_sum_packed2": 3, "plan_segment_sum_sr_packed": 3},
                "gcn_dyn128": {"plan_segment_sum_sr2": 3, "plan_segment_sum_sr_packed": 3}}
    models, ref_models, serve, train, req_s, step_s, losses = {}, {}, {}, {}, {}, {}, {}
    for name, g in graphs.items():
        model = mk[name](generator=torch.Generator().manual_seed(SEED), device=dev).eval()
        ref_model = mk[name](backend="reference", device=dev).eval()
        ref_model.load_state_dict(model.state_dict())
        models[name], ref_models[name] = model, ref_model
        want = {k: per_request[name].get(k, 0) for k in counters}
        outs, req_s[name] = [], []
        reset()  # count this model's serving launches only
        with torch.inference_mode():
            for i in range(REQUESTS):
                before = counts()
                ts = time.perf_counter()
                out = model(x, g)
                torch.cuda.synchronize()
                req_s[name].append(time.perf_counter() - ts)
                expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                                f"{name} request {i}")
                outs.append(out)
            serve[name] = counts()
            ref64 = mk[name](backend="reference", device=dev).double().eval()
            ref64.load_state_dict(model.state_dict())
            oracle = ref64(x.double(), g).float()
            ref32 = ref_model(x, g)
            del ref64
        for i, out in enumerate(outs):
            if out.shape != (n, c) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} request {i}: bad output {tuple(out.shape)}")
            torch.testing.assert_close(out, oracle, **MODEL_TOL)
        log(f"phase 22 {name}: {REQUESTS} requests, launches {serve[name]} (per request "
            f"{per_request[name]}); outputs [{n}, {c}] finite; against the reference path in "
            f"float64 (tolerance {MODEL_TOL}): kernel path max abs err "
            f"{float((outs[0] - oracle).abs().max()):.3e}, float32 reference path "
            f"{float((ref32 - oracle).abs().max()):.3e}; request s: "
            + ", ".join(f"{t:.4f}" for t in req_s[name]))
        del outs, out, oracle, ref32

    # 23. train: 5 AdamW steps per model beside the reference path, and the
    # composed GAT route against the fused one
    arm("gat_train")
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    steps = {}
    for name, g in graphs.items():
        model, ref_model = models[name], ref_models[name]
        step = make_train_step(model, make_optimizer(model, LR, WEIGHT_DECAY), has_dropout=False)
        ref_step = make_train_step(ref_model, make_optimizer(ref_model, LR, WEIGHT_DECAY),
                                   has_dropout=False)
        steps[name] = step
        # step-0 gradients of the reference path (float32, and all in
        # float64) through the kernel path's ReLU pattern (phase 18's rule)
        model.train(False)
        with torch.no_grad():
            _, z_kernel = forward_masked(model, x, g, None)
        relu_masks = [z > 0 for z in z_kernel]
        g_ref, flips = {}, {}
        ref64 = mk[name](backend="reference", device=dev).double()
        ref64.load_state_dict(model.state_dict())
        for tag, m, xx in (("f32", ref_model, x), ("f64", ref64, x.double())):
            m.zero_grad(set_to_none=True)
            out_o, z_ref = forward_masked(m, xx, g, relu_masks)
            cross_entropy_loss(out_o, y, mask).backward()
            g_ref[tag] = {k: prm.grad.float() for k, prm in m.named_parameters()}
            flips[tag] = relu_flips(z_kernel, [z.float() for z in z_ref],
                                    f"phase 23 {name} ({tag} reference)")
        ref_model.zero_grad(set_to_none=True)
        del ref64, out_o, z_kernel, z_ref, relu_masks
        want = {k: per_step[name].get(k, 0) for k in counters}
        losses[name], step_s[name] = [], []
        reset()  # count this model's training launches only
        for i in range(TRAIN_STEPS):
            before = counts()
            ts = time.perf_counter()
            loss = step(x, g, y, mask)
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - ts)
            expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                            f"{name} step {i}")
            loss_r = ref_step(x, g, y, mask)
            if i == 0:
                excess = []
                for pname, prm in model.named_parameters():
                    ratios = []
                    for tag in ("f32", "f64"):
                        gr = g_ref[tag][pname]
                        lim = GRAD_RTOL * gr.abs() + GRAD_RTOL * float(gr.abs().max())
                        ratios.append(float(((prm.grad - gr).abs() / lim).max()))
                        torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                                   atol=GRAD_RTOL * float(gr.abs().max()))
                    excess.append((pname, *ratios))
                log(f"phase 23 {name} step 0 gradients through the kernel path's ReLU pattern "
                    "(sign flips vs the float32 / float64 reference path: "
                    + ", ".join(f"{k_} {n_} at {w_:.3e} * max|z|" for k_, (n_, w_) in flips.items())
                    + "), max |err| / (rtol |g| + atol) per tensor (f32, f64): "
                    + ", ".join(f"{k} ({a:.3f}, {b:.3f})" for k, a, b in excess))
            lk, lr_ = float(loss), float(loss_r)
            if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
                raise AssertionError(f"{name} step {i}: loss {lk} vs reference {lr_}")
            losses[name].append((lk, lr_))
        train[name] = counts()
        log(f"phase 23 {name}: {TRAIN_STEPS} steps, losses (kernel, reference) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses[name])
            + f"; launches {train[name]} (per step {per_step[name]}); step wall s: "
            + ", ".join(f"{t:.4f}" for t in step_s[name]))
    for name, k in (("gat", "plan_segment_sum_mh"), ("gcn_dyn64", "plan_segment_sum_packed2"),
                    ("gcn_dyn128", "plan_segment_sum_sr2")):
        if not serve[name][k] or not train[name][k]:
            raise AssertionError(f"{k} was not launched on the {name} path")
    if not train["gat"]["edge_dots"]:
        raise AssertionError("edge_dots was not launched on the GAT training path")
    del ref_models
    # the composed GAT route (fused_max_edges 0) at both layer widths: one
    # forward and one backward of gat_attention_spmm against the default
    # (the reference's fused) route on the same inputs. Both are one
    # computation here: the mh kernel reads xh[src[e]] and the edge-order
    # attention (forward over plan, the xh gradient over plan_t) at H*D 256
    # and 28, the attention's gradient the per-edge, per-head dot.
    for H, D, want in ((4, FLICKR_HIDDEN, ((2, 1), (2, 1))), (4, c, ((2, 1), (2, 1)))):
        xh = torch.randn(n, H, D, generator=gen, device=dev)
        a_s = 0.3 * torch.randn(n, H, generator=gen, device=dev)
        a_d = 0.3 * torch.randn(n, H, generator=gen, device=dev)
        co = torch.randn(n, H, D, generator=gen, device=dev)
        res = []
        for kw in ({}, {"fused_max_edges": 0}):
            args = [t.clone().requires_grad_() for t in (xh, a_s, a_d)]
            reset()
            out = api.gat_attention_spmm(gg, *args, **kw)
            torch.vdot(out.reshape(-1), co.reshape(-1)).backward()
            torch.cuda.synchronize()
            cn = counts()
            res.append((out.detach(), [t.grad for t in args],
                        (cn["plan_segment_sum_mh"], cn["edge_dots"])))
        (o_f, g_f, l_f), (o_c, g_c, l_c) = res
        if (l_f, l_c) != want:
            raise AssertionError(f"(H, D) = ({H}, {D}): (mh, edge_dots) launches fused {l_f}, "
                                 f"composed {l_c}; expected {want}")
        torch.testing.assert_close(o_c, o_f, **MODEL_TOL)
        for a_, b_ in zip(g_c, g_f):
            torch.testing.assert_close(a_, b_, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * float(b_.abs().max()))
        log(f"phase 23 composed GAT route (fused_max_edges 0), (H, D) = ({H}, {D}): output "
            f"max |composed - fused| {float((o_c - o_f).abs().max()):.3e}, gradients of xh, "
            f"alpha_src, alpha_dst within rtol {GRAD_RTOL}, atol {GRAD_RTOL} * max|g|; (mh, "
            f"edge_dots) launches forward + backward: fused {l_f}, composed {l_c}")
    del res, xh, a_s, a_d, co, o_f, o_c, g_f, g_c

    # 24. timings: each new kernel at its main-path shapes, forward and
    # training step per model, busy share
    arm("gat_timing")
    timing = {}
    plan, nnz = gg.plan, gg.num_edges
    n_out = plan.n_blocks * plan.s_tile
    for H, D in ((4, FLICKR_HIDDEN), (4, c)):
        F = H * D
        xh = torch.randn(n, F, generator=gen, device=dev)
        we = torch.rand(nnz, H, generator=gen, device=dev) + 0.1
        ws = (we.index_select(0, plan.edge_pos.reshape(-1).long())
              * plan.mask.reshape(-1, 1)).contiguous()
        vals = xh.index_select(0, plan.src_slots.reshape(-1))
        # the gathered form the routes run: xh[src[e]] and the edge-order
        # attention read in the kernel
        t_g = cuda_ms(lambda: sk.plan_segment_sum_mh(plan, xh, we, D, src=gg.src))
        t_p = cuda_ms(lambda: ref_ops.plan_segment_sum_mh_plain(plan, xh, we, D, src=gg.src),
                      iters=3, warmup=1)
        t_gather = cuda_ms(lambda: xh.index_select(0, plan.src_slots.reshape(-1)))
        ncsr = mh_node_csr(gg.dst, gg.src, we, n)
        x2 = xh.view(n * H, D)
        # the yardstick computes the same function
        lib_out = torch.sparse.mm(ncsr, x2).reshape(n, F)
        check_close_abs_sum(lib_out, ref_ops.plan_segment_sum_mh_plain(plan, xh, we, D,
                                                                       src=gg.src)[:n],
                            ref_ops.plan_segment_sum_mh_plain(plan, xh.abs(), we, D,
                                                              src=gg.src)[:n],
                            f"phase 24 library yardstick of plan_segment_sum_mh H*D={F}")
        t_lib = cuda_ms(lambda: torch.sparse.mm(ncsr, x2))
        del ncsr, lib_out
        nb = n * F * 4 + nnz * 4 * (1 + H) + n_out * F * 4  # xh once, src, weights, out
        bound, by = bound_ms(nb, 2 * nnz * F)
        rows_ms, _, nb_r = edge_rows_bound(nnz, F, nnz, 4 * H, n_out)
        # the values form: slot-order rows and weights (the TPU kernel's
        # contract), against the plan's head-expanded slot -> row CSR
        t_v = cuda_ms(lambda: sk.plan_segment_sum_mh(plan, vals, ws, D))
        csr = mh_csr(plan, ws)
        v2 = vals.view(-1, D)
        t_vlib = cuda_ms(lambda: torch.sparse.mm(csr, v2))
        bound_v, by_v, nb_v = mh_bound(plan, ws, F)
        timing[("plan_segment_sum_mh", F)] = {
            "ms": t_g, "plain_ms": t_p, "bound_ms": bound, "bound_by": by, "library_ms": t_lib,
            "rows_bound_ms": rows_ms, "form": "gathered (xh[src[e]] read in the kernel)",
            "values_form": {"ms": t_v, "bound_ms": bound_v, "bound_by": by_v,
                            "library_ms": t_vlib, "gather_ms": t_gather}}
        log(f"{card} plan_segment_sum_mh H*D={F} gathered (xh[src[e]] and the edge-order "
            f"weights in the kernel): {t_g:.4f} ms (bound {bound:.4f} ms by {by}: "
            f"{nb / 1e9:.4f} GB, xh's rows once; {rows_ms:.4f} ms with each live edge's row "
            f"once: {nb_r / 1e9:.4f} GB); plain {t_p:.4f} ms; library torch.sparse.mm (the "
            f"head-expanded node CSR [n*{H}, n*{H}] over xh viewed as [n*{H}, {D}]) "
            f"{t_lib:.4f} ms || values form (slot order) {t_v:.4f} ms (bound {bound_v:.4f} ms "
            f"by {by_v}: {nb_v / 1e9:.4f} GB); library (the head-expanded slot -> row CSR) "
            f"{t_vlib:.4f} ms; the [slots, H*D] gather alone {t_gather:.4f} ms")
        del xh, we, ws, vals, csr, v2, x2
    # edge_dots at GAT's shapes: gathered (the route's), values, plain
    # (the parent's route: the plain dot over chunks of gathered rows),
    # bounds; no one PyTorch call computes per-head dots (library null)
    nnz = gg.num_edges
    for H, D in ((4, FLICKR_HIDDEN), (4, c)):
        F = H * D
        a_ = torch.randn(n, F, generator=gen, device=dev)
        b_ = torch.randn(n, F, generator=gen, device=dev)
        bv = b_.index_select(0, gg.src.long())
        t_g = cuda_ms(lambda: edge_dots(a_, b_, gg.dst, gg.src, D))
        t_v = cuda_ms(lambda: edge_dots(a_, bv, gg.dst, None, D))
        t_p = cuda_ms(lambda: edge_dots_plain(a_, b_, gg.dst, gg.src, D), iters=3, warmup=1)
        # a's and b's rows once, dst, src, out [nnz, H]; and with each
        # edge's b row once (a's rows come once per dst in edge order)
        nb = 2 * n * F * 4 + 2 * nnz * 4 + nnz * H * 4
        bound, by = bound_ms(nb, 2 * nnz * F)
        nb_r = n * F * 4 + nnz * F * 4 + 2 * nnz * 4 + nnz * H * 4
        rows_ms, _ = bound_ms(nb_r, 2 * nnz * F)
        nb_v = nnz * F * 4 + n * F * 4 + nnz * 4 + nnz * H * 4
        bound_v, by_v = bound_ms(nb_v, 2 * nnz * F)
        timing[("edge_dots", F)] = {
            "ms": t_g, "plain_ms": t_p, "bound_ms": bound, "bound_by": by, "library_ms": None,
            "rows_bound_ms": rows_ms, "form": "gathered (a[dst[e]] and b[src[e]] in the kernel)",
            "values_form": {"ms": t_v, "bound_ms": bound_v, "bound_by": by_v}}
        log(f"{card} edge_dots (H, D) = ({H}, {D}) over GAT's {nnz} edges: gathered {t_g:.4f} ms "
            f"(bound {bound:.4f} ms by {by}: {nb / 1e9:.4f} GB, a's and b's rows once; "
            f"{rows_ms:.4f} ms with each edge's b row once: {nb_r / 1e9:.4f} GB); values form "
            f"{t_v:.4f} ms (bound {bound_v:.4f}: {nb_v / 1e9:.4f} GB); plain (the parent's "
            f"route) {t_p:.4f} ms")
        del a_, b_, bv
    for name, g, F in (("plan_segment_sum_sr2", g128, FLICKR_HIDDEN),
                       ("plan_segment_sum_sr2", g128, c),
                       ("plan_segment_sum_packed2", g64, FLICKR_HIDDEN),
                       ("plan_segment_sum_packed2", g64, c)):
        plan = g.plan
        we = torch.rand(g.num_edges, generator=gen, device=dev) + 0.1
        fn = getattr(sk, name)
        pl = getattr(ref_ops, name + "_plain")
        lay = {"vals_layout": "edge"} if name == "plan_segment_sum_sr2" else {}
        # the values form: edge-order values (the TPU kernels' contract)
        vals = torch.randn(g.num_edges, F, generator=gen, device=dev)
        t_k = cuda_ms(lambda: fn(plan, vals, w_edge=we, **lay))
        t_p = cuda_ms(lambda: pl(plan, vals, w_edge=we, **lay), iters=3, warmup=1)
        csr = aeb_csr(plan, plan.mask, we)
        t_lib = cuda_ms(lambda: torch.sparse.mm(csr, vals))
        bound, by, nb = aeb_bound(plan, plan.mask, we, F)
        values = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                  "library_ms": t_lib}
        del vals, csr
        # the gathered form, as slot_dyn runs it: edge e reads x[src[e]]
        xg = torch.randn(n, F, generator=gen, device=dev)
        t_kg = cuda_ms(lambda: fn(plan, xg, w_edge=we, src=g.src, **lay))
        t_pg = cuda_ms(lambda: pl(plan, xg, w_edge=we, src=g.src, **lay), iters=3, warmup=1)
        ncsr = node_csr(g.dst, g.src, we, n)
        lib_out = torch.sparse.mm(ncsr, xg)
        check_close_abs_sum(lib_out, pl(plan, xg, w_edge=we, src=g.src, **lay)[:n],
                            pl(plan, xg.abs(), w_edge=we, src=g.src, **lay)[:n],
                            f"phase 24 library yardstick of {name} F={F} (gathered)")
        t_libg = cuda_ms(lambda: torch.sparse.mm(ncsr, xg))
        bound_g, by_g, nb_g = gathered_bound(n, F, g.num_edges, True, plan.n_blocks * plan.s_tile)
        timing[(name, F)] = {"ms": t_kg, "plain_ms": t_pg, "bound_ms": bound_g,
                             "bound_by": by_g, "library_ms": t_libg, "values_form": values}
        log(f"{card} {name} F={F} (per-call weights, pack_align {plan.pack_align}): gathered "
            f"form (x[src[e]] in the kernel) {t_kg:.4f} ms (bound {bound_g:.4f} ms by {by_g}: "
            f"{nb_g / 1e9:.4f} GB, x's rows once); plain {t_pg:.4f} ms; library torch.sparse.mm "
            f"(the node [n, n] CSR with these weights) {t_libg:.4f} ms || values form "
            f"(edge-order values) {t_k:.4f} ms (bound {bound:.4f} ms by {by}: {nb / 1e9:.4f} GB); "
            f"plain {t_p:.4f} ms; library torch.sparse.mm (the plan's edge -> row CSR) "
            f"{t_lib:.4f} ms")
        del xg, ncsr, lib_out
    fwd, stp, busy = {}, {}, {}
    for name, g in graphs.items():
        model = models[name]
        model.eval()
        with torch.inference_mode():
            fwd[name] = cuda_ms(lambda: model(x, g), iters=10)
        stp[name] = cuda_ms(lambda: steps[name](x, g, y, mask), iters=5, warmup=2)

        def serve_once():
            model.eval()
            with torch.inference_mode():
                model(x, g)

        for mode, run in (("serve", serve_once), ("train", lambda: steps[name](x, g, y, mask))):
            prof, wall_us, busy_us, events = trace(run, 3)
            top = sorted(prof.key_averages(), key=lambda ev: -ev.self_device_time_total)[:6]
            busy[(name, mode)] = busy_us / max(wall_us, 1e-9)
            log(f"{card} {name} {mode} x3: traced wall {wall_us / 1e3:.4f} ms, device "
                f"{busy_us / 1e3:.4f} ms, busy share {busy[(name, mode)]:.4f}; top device "
                "time: " + "; ".join(f"{ev.key[:48]} {ev.self_device_time_total / 1e3:.4f} ms "
                                     f"x{ev.count}" for ev in top))
        log(f"{card} {name}: forward {fwd[name]:.4f} ms (request wall "
            f"{min(req_s[name]) * 1e3:.4f} ms min); training step {stp[name]:.4f} ms (step "
            f"wall {min(step_s[name]) * 1e3:.4f} ms min)")
    faulthandler.cancel_dump_traceback_later()
    return {"serve": serve, "train": train, "errs": errs, "timing": timing,
            "forward_ms": fwd, "train_step_ms": stp, "busy": busy,
            "losses": losses}


def bat_packed_bound(bp, nnz, F, weighted):
    """The least time of one packed BAT launch: each edge's value row, dst
    id (k-major, every value block and the sentinel) and weight read once,
    out_block and vblock, and every output row written once (bytes); or
    its f32 flops, 2 per value weighted, 1 unweighted."""
    n_bytes = (nnz * F * 4 + bp.dst_km.numel() * 4 + (nnz * 4 if weighted else 0)
               + bp.num_tiles * 8 + bp.n_blocks * bp.s_tile * F * 4)
    bound, by = bound_ms(n_bytes, (2 if weighted else 1) * nnz * F)
    return bound, by, n_bytes


def edge_csr(dst, w, n_rows):
    """The edge -> row matrix [n_rows, nnz] in CSR with weights w (ones
    where None): sum_e w_e v_e into row dst_e. For the library yardstick
    only."""
    nnz = dst.shape[0]
    vals = torch.ones(nnz, device=dst.device) if w is None else w
    return torch.sparse_coo_tensor(
        torch.stack([dst.long(), torch.arange(nnz, device=dst.device)]), vals,
        (n_rows, nnz), check_invariants=False).coalesce().to_sparse_csr()


def check_model(out, ref, what):
    """A request of the kernel path against the float64 reference path,
    element by element: |out - ref| <= rtol |ref| + atol * max(1, max|ref|
    of its row) (MODEL_TOL's values). GIN's outputs are unnormalized sums
    over up to ~90 k in-edges a layer, so an output near 0 is a
    cancellation of terms its row's scale; APPNP's are O(1). Returns the
    max abs error."""
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    err = (out - ref).abs()
    lim = MODEL_TOL["rtol"] * ref.abs() + MODEL_TOL["atol"] * scale
    bad = int((err > lim).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: {bad} outputs over tolerance, max err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def run_narrow(dev, card):
    """Phases 25-29: GIN (hidden 64) on the arxiv graph and APPNP (K 10) on
    the flickr graph over packed narrow-feature BAT plans, serving and
    training. Returns the numbers for the kernels line."""
    import torch.nn.functional as F_

    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import build_bat_plan, compute_chunks, with_chunks
    from geot_tpu_torch.models import APPNP, GIN, make_optimizer, make_train_step, prepare_graph
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_packed
    from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat
    from geot_tpu_torch.ops.stream_kernels import stream_segment_acc, stream_segment_sum
    from geot_tpu_torch.profile_gcn import (
        APPNP_KW,
        ARXIV_GIN,
        FLICKR_APPNP,
        FLICKR_HIDDEN,
        GIN_HIDDEN,
        trace,
    )

    counters = {k: getattr(sk, k) for k in (
        "plan_segment_sum_sr", "plan_segment_sum_sr_packed", "plan_segment_sum_pr",
        "plan_segment_sum_mh", "plan_segment_sum_sr2", "plan_segment_sum_packed2")}
    counters.update({"bat_segment_sum": bat_segment_sum,
                     "bat_segment_sum_packed": bat_segment_sum_packed, "sddmm_bat": sddmm_bat,
                     "stream_segment_sum": stream_segment_sum,
                     "stream_segment_acc": stream_segment_acc})
    PK = "bat_segment_sum_packed"

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # 25. host build: GIN's arxiv graph (no self-loops, unweighted) and
    # APPNP's flickr graph (self-loops, no baked norm), packed BAT only
    arm("narrow_build")
    datasets, graphs = {}, {}
    for name, shape, kw, extra in (("gin", "ogbn-arxiv", ARXIV_GIN, {}),
                                   ("appnp", "flickr", FLICKR_APPNP, {"power": 1.0})):
        n, e, f, c = DATASET_SHAPES[shape]
        data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=SEED, **extra)
        t0 = time.perf_counter()
        g = prepare_graph(data.src, data.dst, n, device=dev, **kw)
        torch.cuda.synchronize()
        datasets[name], graphs[name] = (data, f, c), g
        for d in ("bat", "bat_t"):
            bp = getattr(g, d)
            log(f"phase 25 {name} {d}: km_pack {bp.km_pack}, dst_km {tuple(bp.dst_km.shape)}, "
                f"{bp.num_tiles} tiles of {bp.e_tile} x {bp.s_tile}, {bp.n_blocks} windows, "
                f"chunks {max(len(bp.chunks), 1)}")
        log(f"phase 25 {name} graph ({shape}, {g.num_edges} edges): prepare_graph "
            f"{time.perf_counter() - t0:.2f}s; edge-row schedules (host build, bytes on the "
            f"card): " + ", ".join(f"{d} {v['seconds']:.3f}s {v['bytes'] / 1e6:.2f} MB"
                                   for d, v in g.build_stats["row_schedule"].items()))
    gg, ga = graphs["gin"], graphs["appnp"]
    routes = (api.dispatch_path(gg), api.dispatch_path(ga, dynamic_w=True))
    packs = (gg.bat.km_pack, gg.bat_t.km_pack, ga.bat.km_pack, ga.bat_t.km_pack)
    if routes != ("bat", "bat_dyn") or packs != (2, 2, 16, 16):
        raise AssertionError(f"dispatch_path {routes}, km_pack {packs}: expected ('bat', "
                             "'bat_dyn') and (2, 2, 16, 16)")
    if ga.w_slots is not None or ga.edge_weight is not None:
        raise AssertionError("the APPNP graph holds weights: its norm must be per call")
    log("phase 25 dispatch_path: GIN 'bat' (pack 2: layers 2-3 at 64 columns packed, layer 1 "
        "at 128 wide), APPNP per-call norm 'bat_dyn' (pack 16: 7 columns padded to 8)")

    # 26. the packed kernel against its plain version
    arm("narrow_kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    err = 0.0
    n_checks = 0

    def held(k, p, a, what, rerun):
        nonlocal err, n_checks
        err = max(err, check_close_abs_sum(k, p, a, f"phase 26 {what}"))
        for _ in range(3):
            if not torch.equal(rerun(), k):
                raise AssertionError(f"phase 26 {what}: not deterministic")
        n_checks += 1

    # each pack on a real plan: arxiv's 2, flickr's 16, and flickr's dst
    # sorted into plans of pack 4 and 8; ragged value rows (nnz, short of
    # whole blocks); unweighted, weighted, and every third weight 0
    fa_dst = ga.dst.cpu().numpy()
    plans = [("gin.bat", gg.bat, gg.src, gg.num_nodes),
             ("gin.bat_t", gg.bat_t, gg.dst_t, gg.num_nodes),
             ("appnp.bat", ga.bat, ga.src, ga.num_nodes),
             ("appnp.bat_t", ga.bat_t, ga.dst_t, ga.num_nodes)]
    for pack in (4, 8):
        plans.append((f"appnp dst pack {pack}",
                      build_bat_plan(fa_dst, ga.num_nodes, e_tile=512, s_tile=256,
                                     km_pack=pack, device=dev), ga.src, ga.num_nodes))
    for label, bp, src_d, n_nodes in plans:
        Fw = 128 // bp.km_pack
        nnz = src_d.shape[0]
        w = torch.rand(nnz, generator=gen, device=dev) + 0.1
        w0 = torch.where(torch.arange(nnz, device=dev) % 3 == 1, 0.0, w)
        # the values form (edge-order rows) and the gathered form (x[src[e]]
        # read in the kernel, as the routes run it)
        for form, vals, kw in (("values", torch.randn(nnz, Fw, generator=gen, device=dev), {}),
                               ("gathered", torch.randn(n_nodes, Fw, generator=gen,
                                                        device=dev), {"src": src_d})):
            for wl, ww in (("unweighted", None), ("weighted", w), ("every third weight 0", w0)):
                k = bat_segment_sum_packed(bp, vals, ww, **kw)
                torch.cuda.synchronize()
                held(k, ref_ops.bat_segment_sum_packed_plain(bp, vals, ww, **kw),
                     ref_ops.bat_segment_sum_packed_plain(bp, vals.abs(),
                                                          None if ww is None else ww.abs(),
                                                          **kw),
                     f"{label} F={Fw} {form} {wl}",
                     lambda: bat_segment_sum_packed(bp, vals, ww, **kw))
            del vals, k
    # the routes with ragged widths (7 -> 8, 40 -> 64) and a plan forced
    # into chunks that split the hub window, against the whole plan's
    # plain sum
    for name, Fn in (("appnp", 7), ("gin", 40)):
        g = graphs[name]
        bp = g.bat
        cap = max(int(torch.bincount(bp.out_block.long()).max()) // 3, 2)
        ch = compute_chunks(bp.out_block.cpu().numpy(), cap)
        split = [b for a, b in zip(ch[:-1], ch[1:]) if b[2] < a[3]]
        if len(ch) < 3 or not split:
            raise AssertionError("forced chunking did not split a hub window")
        bpc = with_chunks(bp, ch)
        xf = torch.randn(g.num_nodes, Fn, generator=gen, device=dev)
        w = torch.rand(g.num_edges, generator=gen, device=dev) + 0.1
        vals = F_.pad(xf, (0, 128 // bp.km_pack - Fn)).index_select(0, g.src.long())
        want = ref_ops.bat_segment_sum_packed_plain(bp, vals, w)[: g.num_nodes, :Fn]
        a = ref_ops.bat_segment_sum_packed_plain(bp, vals.abs(), w)[: g.num_nodes, :Fn]
        with torch.inference_mode():
            for lbl, plan in (("whole", bp), (f"{len(ch)} chunks, hub window split", bpc)):
                before = bat_segment_sum_packed.launches
                got = api._spmm_fwd_bat(plan, xf, g.src, w)
                torch.cuda.synchronize()
                expect_launches(bat_segment_sum_packed.launches - before, 1,
                                f"phase 26 {name} route {lbl} (one launch a plan)")
                held(got, want, a, f"{name} route F={Fn} ({lbl})",
                     lambda: api._spmm_fwd_bat(plan, xf, g.src, w))
        del xf, vals, want, a, got
    log(f"phase 26 {n_checks} packed-kernel checks within the abs-sum rule, each rerun 3 times "
        "bit-identical")

    # 27. serve: 5 requests per model against the reference path in float64
    arm("narrow_serve")
    mk = {"gin": lambda f, c, **kw: GIN(f, GIN_HIDDEN, 3, c, **kw),
          "appnp": lambda f, c, **kw: APPNP(f, FLICKR_HIDDEN, 2, c, **APPNP_KW, **kw)}
    # both BAT sums: one launch a plan, chunked or not (GIN's 128-wide layer
    # 1 runs the wide sum over its packed plan's schedule)
    per_request = {"gin": {"bat_segment_sum": 1, PK: 2}, "appnp": {PK: 10}}
    per_step = {"gin": {"bat_segment_sum": 1, PK: 4}, "appnp": {PK: 20}}
    models, ref_models, xs, serve, train, req_s, step_s, losses = {}, {}, {}, {}, {}, {}, {}, {}
    for name, g in graphs.items():
        data, f, c = datasets[name]
        x = torch.from_numpy(data.x).to(dev)
        xs[name] = x
        model = mk[name](f, c, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
        ref_model = mk[name](f, c, backend="reference", device=dev).eval()
        ref_model.load_state_dict(model.state_dict())
        models[name], ref_models[name] = model, ref_model
        want = {k: per_request[name].get(k, 0) for k in counters}
        outs, req_s[name] = [], []
        reset()  # count this model's serving launches only
        with torch.inference_mode():
            for i in range(REQUESTS):
                before = counts()
                ts = time.perf_counter()
                out = model(x, g)
                torch.cuda.synchronize()
                req_s[name].append(time.perf_counter() - ts)
                expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                                f"{name} request {i}")
                outs.append(out)
            serve[name] = counts()
            ref64 = mk[name](f, c, backend="reference", device=dev).double().eval()
            ref64.load_state_dict(model.state_dict())
            oracle = ref64(x.double(), g).float()
            ref32 = ref_model(x, g)
            del ref64
        for i, out in enumerate(outs):
            if out.shape != (g.num_nodes, c):
                raise AssertionError(f"{name} request {i}: bad output {tuple(out.shape)}")
            e_i = check_model(out, oracle, f"phase 27 {name} request {i}")
        log(f"phase 27 {name}: {REQUESTS} requests, launches {serve[name]} (per request "
            f"{per_request[name]}); outputs [{g.num_nodes}, {c}] finite, max |ref| "
            f"{float(oracle.abs().max()):.3e}; against the reference path in float64 (rtol "
            f"{MODEL_TOL['rtol']}, atol {MODEL_TOL['atol']} * max(1, row max |ref|)): kernel path "
            f"max abs err {e_i:.3e}, float32 reference path "
            f"{float((ref32 - oracle).abs().max()):.3e}; request s: "
            + ", ".join(f"{t:.4f}" for t in req_s[name]))
        del outs, out, oracle, ref32

    # 28. train: 5 AdamW steps per model, each beside the same step on the
    # reference path from the same state (parameters and AdamW moments
    # copied over before every step): GIN's unnormalized sums make its
    # trajectory chaotic, so two paths left to run apart diverge in a few
    # steps from rounding alone (the float32 reference path from itself too,
    # its index_add_ being atomics), while each step's arithmetic is what
    # is held here
    arm("narrow_train")
    steps, ys, masks = {}, {}, {}
    for name, g in graphs.items():
        data = datasets[name][0]
        x = xs[name]
        y = torch.from_numpy(data.y.astype("int64")).to(dev)
        mask = torch.from_numpy(data.train_mask).to(dev)
        ys[name], masks[name] = y, mask
        model, ref_model = models[name], ref_models[name]
        opt = make_optimizer(model, LR, WEIGHT_DECAY)
        ref_opt = make_optimizer(ref_model, LR, WEIGHT_DECAY)
        step = make_train_step(model, opt, has_dropout=False)
        ref_step = make_train_step(ref_model, ref_opt, has_dropout=False)
        steps[name] = step
        want = {k: per_step[name].get(k, 0) for k in counters}
        losses[name], step_s[name] = [], []
        reset()  # count this model's training launches only
        for i in range(TRAIN_STEPS):
            state = copy.deepcopy((model.state_dict(), opt.state_dict()))
            before = counts()
            ts = time.perf_counter()
            loss = step(x, g, y, mask)
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - ts)
            expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                            f"{name} step {i}")
            ref_model.load_state_dict(state[0])
            ref_opt.load_state_dict(state[1])
            loss_r = ref_step(x, g, y, mask)
            del state
            if i == 0:
                pr = dict(ref_model.named_parameters())
                ratios = []
                for pname, prm in model.named_parameters():
                    gr = pr[pname].grad
                    lim = GRAD_RTOL * gr.abs() + GRAD_RTOL * float(gr.abs().max())
                    ratios.append((pname, float(((prm.grad - gr).abs() / lim).max())))
                    torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                               atol=GRAD_RTOL * float(gr.abs().max()))
                log(f"phase 28 {name} step 0 gradients agree per tensor (rtol {GRAD_RTOL}, atol "
                    f"{GRAD_RTOL} * max|g_ref|); max |err| / (rtol |g| + atol): "
                    + ", ".join(f"{k} {r:.3f}" for k, r in ratios))
            lk, lr_ = float(loss), float(loss_r)
            if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
                raise AssertionError(f"{name} step {i}: loss {lk} vs reference {lr_}")
            losses[name].append((lk, lr_))
        train[name] = counts()
        log(f"phase 28 {name}: {TRAIN_STEPS} steps, losses (kernel, reference) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses[name])
            + f"; launches {train[name]} (per step {per_step[name]}); step wall s: "
            + ", ".join(f"{t:.4f}" for t in step_s[name]))
    for name in graphs:
        if not serve[name][PK] or not train[name][PK]:
            raise AssertionError(f"{PK} was not launched on the {name} path")
    del ref_models

    # 29. timings: the packed kernel at each real shape, its plain version,
    # its bound, torch.sparse.mm over the edge -> row CSR, and the wide
    # kernel on the same values padded to 128 columns over an unpacked
    # plan; a request and a step of each model with the busy share
    arm("narrow_timing")
    timing = {}
    for name, d, weighted in (("gin", "bat", False), ("gin", "bat_t", False),
                              ("appnp", "bat", True), ("appnp", "bat_t", True)):
        g = graphs[name]
        bp = getattr(g, d)
        nnz, nn = g.num_edges, g.num_nodes
        Fw = 128 // bp.km_pack
        dst_d = g.dst if d == "bat" else g.src.index_select(0, g.perm_t.long())
        src_d = g.src if d == "bat" else g.dst_t
        w = (torch.rand(nnz, generator=gen, device=dev) + 0.1) if weighted else None
        # the values form: edge-order rows
        vals = torch.randn(nnz, Fw, generator=gen, device=dev)
        t_k = cuda_ms(lambda: bat_segment_sum_packed(bp, vals, w))
        t_p = cuda_ms(lambda: ref_ops.bat_segment_sum_packed_plain(bp, vals, w), iters=3,
                      warmup=1)
        csr = edge_csr(dst_d, w, bp.n_blocks * bp.s_tile)
        lib_out = torch.sparse.mm(csr, vals)
        check_close_abs_sum(lib_out, ref_ops.bat_segment_sum_packed_plain(bp, vals, w),
                            ref_ops.bat_segment_sum_packed_plain(
                                bp, vals.abs(), None if w is None else w.abs()),
                            f"phase 29 library yardstick {name}.{d} F={Fw}")
        t_lib = cuda_ms(lambda: torch.sparse.mm(csr, vals))
        wide = build_bat_plan(dst_d.cpu().numpy(), g.num_nodes, e_tile=bp.e_tile,
                              s_tile=bp.s_tile, device=dev)
        v128 = F_.pad(vals, (0, 128 - Fw))
        t_wide = cuda_ms(lambda: bat_segment_sum(wide, v128, w))
        bound, by, nb = bat_packed_bound(bp, nnz, Fw, weighted)
        values = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                  "library_ms": t_lib, "wide_128_ms": t_wide}
        del vals, csr, lib_out, wide, v128
        # the gathered form, as the routes run it: x[src[e]] in the kernel
        xg = torch.randn(nn, Fw, generator=gen, device=dev)
        t_kg = cuda_ms(lambda: bat_segment_sum_packed(bp, xg, w, src=src_d))
        t_pg = cuda_ms(lambda: ref_ops.bat_segment_sum_packed_plain(bp, xg, w, src=src_d),
                       iters=3, warmup=1)
        ncsr = node_csr(dst_d, src_d, w, nn)
        lib_out = torch.sparse.mm(ncsr, xg)
        check_close_abs_sum(lib_out, ref_ops.bat_segment_sum_packed_plain(
            bp, xg, w, src=src_d)[:nn], ref_ops.bat_segment_sum_packed_plain(
            bp, xg.abs(), None if w is None else w.abs(), src=src_d)[:nn],
            f"phase 29 library yardstick {name}.{d} F={Fw} (gathered)")
        t_libg = cuda_ms(lambda: torch.sparse.mm(ncsr, xg))
        bound_g, by_g, nb_g = gathered_bound(nn, Fw, nnz, weighted, bp.n_blocks * bp.s_tile)
        timing[(name, d)] = {"F": Fw, "ms": t_kg, "plain_ms": t_pg, "bound_ms": bound_g,
                             "bound_by": by_g, "library_ms": t_libg, "values_form": values}
        log(f"{card} bat_segment_sum_packed {name}.{d} F={Fw} (pack {bp.km_pack}, "
            f"{'weighted' if weighted else 'unweighted'}): gathered form (x[src[e]] in the "
            f"kernel) {t_kg:.4f} ms (bound {bound_g:.4f} ms by {by_g}: {nb_g / 1e9:.4f} GB, x's "
            f"rows once); plain {t_pg:.4f} ms; library torch.sparse.mm (the node [n, n] CSR) "
            f"{t_libg:.4f} ms || values form {t_k:.4f} ms (bound {bound:.4f} ms by {by}: "
            f"{nb / 1e9:.4f} GB); plain {t_p:.4f} ms; library torch.sparse.mm (the edge -> row "
            f"CSR, [{nnz}, {Fw}] values) {t_lib:.4f} ms; wide bat_segment_sum on the values "
            f"padded to 128 over an unpacked plan {t_wide:.4f} ms")
        del xg, ncsr, lib_out
    fwd, stp, busy = {}, {}, {}
    for name, g in graphs.items():
        model, x, y, mask = models[name], xs[name], ys[name], masks[name]
        model.eval()
        with torch.inference_mode():
            fwd[name] = cuda_ms(lambda: model(x, g), iters=10)
        stp[name] = cuda_ms(lambda: steps[name](x, g, y, mask), iters=5, warmup=2)

        def serve_once():
            model.eval()
            with torch.inference_mode():
                model(x, g)

        for mode, run in (("serve", serve_once), ("train", lambda: steps[name](x, g, y, mask))):
            prof, wall_us, busy_us, events = trace(run, 3)
            top = sorted(prof.key_averages(), key=lambda ev: -ev.self_device_time_total)[:6]
            busy[(name, mode)] = busy_us / max(wall_us, 1e-9)
            log(f"{card} {name} {mode} x3: traced wall {wall_us / 1e3:.4f} ms, device "
                f"{busy_us / 1e3:.4f} ms, busy share {busy[(name, mode)]:.4f}; top device "
                "time: " + "; ".join(f"{ev.key[:48]} {ev.self_device_time_total / 1e3:.4f} ms "
                                     f"x{ev.count}" for ev in top))
        log(f"{card} {name}: forward {fwd[name]:.4f} ms (request wall "
            f"{min(req_s[name]) * 1e3:.4f} ms min); training step {stp[name]:.4f} ms (step "
            f"wall {min(step_s[name]) * 1e3:.4f} ms min)")
    faulthandler.cancel_dump_traceback_later()
    return {"serve": serve, "train": train, "err": err, "timing": timing,
            "forward_ms": fwd, "train_step_ms": stp, "busy": busy, "losses": losses}


def prod_close(k, p, deg, what):
    """A prod on the card against the CPU's: per row |k - p| <= 2 * n * u *
    |p| (n the row's terms, u = 2**-24: each product rounds once, in any
    order) + 1e-30."""
    lim = 2.0 * deg.clamp(min=1)[:, None].float() * 2.0 ** -24 * p.abs() + 1e-30
    bad = int(((k - p).abs() > lim).sum())
    log(f"{what}: max_rel_err={float(((k - p).abs() / p.abs().clamp(min=1e-30)).max()):.3e} "
        f"over_tolerance={bad}")
    if bad or not torch.isfinite(k).all():
        raise AssertionError(f"{what}: the card's prod disagrees with the CPU's")


def run_bucketed(dev, card, data):
    """Phases 30-35: the arxiv GCN over the bucketed BAT route (build, kernel
    checks, serving, training, timings), with BasicGNN's norms and jumping
    knowledge, max and prod on the card, and the graph cache. Returns the
    numbers for the kernels line."""
    import os
    import shutil
    import tempfile

    from geot_tpu_torch.graph.cache import load_graph, save_graph
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES
    from geot_tpu_torch.graph.plan import row_schedule_of
    from geot_tpu_torch.models import (
        GCN,
        cross_entropy_loss,
        make_optimizer,
        make_train_step,
        prepare_graph,
    )
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import (
        bat_segment_sum,
        bat_segment_sum_packed,
        bucketed_sum,
        bucketed_sum_plain,
    )
    from geot_tpu_torch.ops.sddmm_kernels import edge_dots, sddmm_bat
    from geot_tpu_torch.ops.stream_kernels import stream_segment_acc, stream_segment_sum

    counters = {k: getattr(sk, k) for k in (
        "plan_segment_sum_sr", "plan_segment_sum_sr_packed", "plan_segment_sum_pr",
        "plan_segment_sum_mh", "plan_segment_sum_sr2", "plan_segment_sum_packed2")}
    counters.update({"bat_segment_sum": bat_segment_sum,
                     "bat_segment_sum_packed": bat_segment_sum_packed, "sddmm_bat": sddmm_bat,
                     "edge_dots": edge_dots, "stream_segment_sum": stream_segment_sum,
                     "stream_segment_acc": stream_segment_acc})
    BS = "bat_segment_sum"

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # 30. host build: the arxiv graph with the GCN norm baked in, BAT and
    # bucketed BAT plans (two buckets of 131,072 rows)
    arm("bucket_build")
    n, _, f, c = DATASET_SHAPES["ogbn-arxiv"]
    t0 = time.perf_counter()
    g = prepare_graph(data.src, data.dst, n, layouts=("bat",), normalize="gcn",
                      bucket_table_bytes=1, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if api.dispatch_path(g) != "bucketed" or api.dispatch_path(g, dynamic_w=True) != "bat_dyn":
        raise AssertionError(f"dispatch_path {api.dispatch_path(g)!r}: expected 'bucketed' "
                             "(and 'bat_dyn' for per-call weights)")
    sched = g.build_stats["row_schedule"]
    log(f"phase 30 graph ({n} nodes, {g.num_edges} edges with self-loops, the GCN norm baked "
        f"in): prepare_graph {build_s:.2f}s; steps: " + ", ".join(
            f"{k} {v:.2f}s" for k, v in g.build_stats["seconds"].items()))
    for name in ("bat", "bat_t", "bat_b", "bat_b_t"):
        p = getattr(g, name)
        extra = (f", {len({ch[4] for ch in p.chunks})} buckets of {p.bucket_rows} rows, "
                 f"{p.n_vblocks} padded value blocks" if name.startswith("bat_b") else "")
        log(f"phase 30 {name}: {p.num_tiles} tiles of {p.e_tile} x {p.s_tile}, "
            f"{max(len(p.chunks), 1)} chunks{extra}; edge-row schedule "
            f"{sched[name]['seconds']:.3f}s, {sched[name]['bytes'] / 1e6:.2f} MB on the card, "
            f"{p.row_sched.cols.shape[0]} entries")
    log("phase 30 dispatch_path: 'bucketed' (the graph's own weights), 'bat_dyn' (per-call)")

    # 31. the bucketed sum against its plain version on both directions at
    # the layers' widths, one launch a plan, three reruns bit-identical
    arm("bucket_kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    err, n_checks = 0.0, 0
    for F in (128, c):
        xf = torch.randn(n, F, generator=gen, device=dev)
        for d in ("bat_b", "bat_b_t"):
            bb = getattr(g, d)
            what = f"phase 31 bucketed_sum {d} F={F}"
            before = bat_segment_sum.launches
            k = bucketed_sum(bb, xf)
            torch.cuda.synchronize()
            expect_launches(bat_segment_sum.launches - before, 1, f"{what} (one launch)")
            p = bucketed_sum_plain(bb, xf)
            a = bucketed_sum_plain(dataclasses.replace(bb, w_pad=bb.w_pad.abs()), xf.abs())
            err = max(err, check_close_abs_sum(k, p, a, what))
            for _ in range(3):
                if not torch.equal(bucketed_sum(bb, xf), k):
                    raise AssertionError(f"{what}: not deterministic")
            n_checks += 1
        del xf, k, p, a
    log(f"phase 31 {n_checks} bucketed_sum checks within the abs-sum rule, three reruns "
        "bit-identical each")

    # 32. serve and train the GCN over the bucketed route, and the norm /
    # jumping-knowledge variants, each against the reference path
    arm("bucket_serve")
    x = torch.from_numpy(data.x).to(dev)
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    variants = {"gcn": ({}, REQUESTS, TRAIN_STEPS),
                "gcn_layer_cat": ({"norm": "layer", "jk": "cat"}, 2, 2),
                "gcn_batch_max_act_first": ({"norm": "batch", "jk": "max", "act_first": True},
                                            2, 2)}
    serve, train, losses, models, steps, req_s, c19 = {}, {}, {}, {}, {}, {}, {}
    for name, (kw, n_req, n_steps) in variants.items():
        mk = dict(conv_kwargs={"normalize": False}, **kw)
        model = GCN(f, 128, 3, c, generator=torch.Generator().manual_seed(SEED), device=dev,
                    **mk).eval()
        ref_model = GCN(f, 128, 3, c, backend="reference", device=dev, **mk).eval()
        ref_model.load_state_dict(model.state_dict())
        # the oracle: the reference path in float64, as phase 12 (ROADMAP
        # C.7): the f32 reference path's hub rows (92,346 terms) sum in
        # index_add_'s atomic order, a few 1e-4 from float64 after BatchNorm
        ref64 = GCN(f, 128, 3, c, backend="reference", device=dev, **mk).double().eval()
        ref64.load_state_dict(model.state_dict())
        with torch.inference_mode():
            ref32 = ref_model(x, g)
            ref = ref64(x.double(), g).float()
        want = {k: (3 if k == BS else 0) for k in counters}
        reset()
        req_s[name] = []
        with torch.inference_mode():
            for i in range(n_req):
                before = counts()
                ts = time.perf_counter()
                out = model(x, g)
                torch.cuda.synchronize()
                req_s[name].append(time.perf_counter() - ts)
                expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                                f"phase 32 {name} request {i}")
                if out.shape != (n, c) or not torch.isfinite(out).all():
                    raise AssertionError(f"{name} request {i}: bad output {tuple(out.shape)}")
                torch.testing.assert_close(out, ref, **MODEL_TOL)
        serve[name] = counts()
        log(f"phase 32 {name}: {n_req} requests, launches {serve[name][BS]} bat_segment_sum "
            f"(3 a request, one bucketed launch a layer), max |kernel path - reference path in "
            f"float64| {float((out - ref).abs().max()):.3e} (tolerance {MODEL_TOL}; the f32 "
            f"reference path's: {float((ref32 - ref).abs().max()):.3e}, kernel path - f32 "
            f"reference path {float((out - ref32).abs().max()):.3e}); request s: "
            + ", ".join(f"{t:.4f}" for t in req_s[name]))
        del out, ref, ref32
        opt = make_optimizer(model, LR, WEIGHT_DECAY)
        ref_opt = make_optimizer(ref_model, LR, WEIGHT_DECAY)
        step = make_train_step(model, opt, has_dropout=False)
        ref_step = make_train_step(ref_model, ref_opt, has_dropout=False)
        want = {k: (6 if k == BS else 0) for k in counters}
        if kw.get("norm"):
            # the step-0 gradients on the reference path in float64, from
            # the same state and in the step's mode, no dropout (phase 39
            # holds the norm variants to them)
            cross_entropy_loss(ref64(x.double(), g), y, mask).backward()
            g64 = {k: p_.grad.clone() for k, p_ in ref64.named_parameters()}
        del ref64
        reset()
        losses[name] = []
        for i in range(n_steps):
            before = counts()
            loss = step(x, g, y, mask)
            torch.cuda.synchronize()
            expect_launches({k: v - before[k] for k, v in counts().items()}, want,
                            f"phase 32 {name} step {i}")
            loss_r = ref_step(x, g, y, mask)
            if i == 0 and kw.get("norm"):
                c19[name] = ({k: p_.grad.clone() for k, p_ in model.named_parameters()},
                             {k: p_.grad.clone() for k, p_ in ref_model.named_parameters()},
                             g64)
            elif i == 0:
                # phase 8's rule: atol GRAD_RTOL * max|g_ref| of the tensor
                pr = dict(ref_model.named_parameters())
                ratios = []
                for pname, prm in model.named_parameters():
                    gr = pr[pname].grad
                    scale = float(gr.abs().max())
                    ratios.append((pname, float((prm.grad - gr).abs().max()) / scale))
                    torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                               atol=GRAD_RTOL * scale)
                log(f"phase 32 {name} step 0 gradients: max |kernel - reference| / "
                    "max|g_ref|: " + ", ".join(f"{k} {r:.2e}" for k, r in ratios))
            lk, lr_ = float(loss), float(loss_r)
            if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
                raise AssertionError(f"{name} step {i}: loss {lk} vs reference {lr_}")
            losses[name].append((lk, lr_))
        train[name] = counts()
        log(f"phase 32 {name}: {n_steps} steps (step 0 gradients "
            + ("held per tensor against float64 in phase 39" if kw.get("norm")
               else f"within rtol {GRAD_RTOL}") + "), "
            f"losses (kernel, reference) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses[name])
            + f"; bat_segment_sum {train[name][BS]} (3 forward + 3 over bat_b_t a step)")
        models[name], steps[name] = model, step
        del ref_model, ref_opt
    for name in variants:
        if not serve[name][BS] or not train[name][BS]:
            raise AssertionError(f"the bucketed route launched no kernel on {name}")

    # 33. timings: the bucketed SpMM beside the bat_static SpMM on the same
    # graph and weights, the bound, the plain version, torch.sparse.mm over
    # the node CSR; a request and a step
    arm("bucket_timing")
    nnz = g.num_edges
    timing = {}
    for F in (128, c):
        xf = torch.randn(n, F, generator=gen, device=dev)
        r = {"F": F}
        r["ms"] = cuda_ms(lambda: api._spmm_fwd_bucketed(g.bat_b, xf))
        r["bat_static_ms"] = cuda_ms(lambda: api._spmm_fwd_bat(g.bat, xf, g.src, g.edge_weight))
        r["plain_ms"] = cuda_ms(lambda: bucketed_sum_plain(g.bat_b, xf), iters=3, warmup=1)
        r["bound_ms"], r["bound_by"], nb = gathered_bound(n, F, nnz, True,
                                                          g.bat_b.n_blocks * g.bat_b.s_tile)
        ncsr = node_csr(g.dst, g.src, g.edge_weight, n)
        lib = torch.sparse.mm(ncsr, xf)
        check_close_abs_sum(api._spmm_fwd_bucketed(g.bat_b, xf), lib,
                            torch.sparse.mm(node_csr(g.dst, g.src, g.edge_weight.abs(), n),
                                            xf.abs()),
                            f"phase 33 library yardstick F={F}")
        r["library_ms"] = cuda_ms(lambda: torch.sparse.mm(ncsr, xf))
        timing[F] = r
        log(f"{card} bucketed SpMM (arxiv GCN, F={F}; bucketed_sum over bat_b, x[src[e]] read "
            f"in the kernel) {r['ms']:.4f} ms; bat_static SpMM on the same graph "
            f"{r['bat_static_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({nb / 1e9:.4f} GB, x's rows once); plain {r['plain_ms']:.4f} ms; library "
            f"torch.sparse.mm (node CSR) {r['library_ms']:.4f} ms")
        del xf, ncsr, lib
    fwd, stp = {}, {}
    for name, model in models.items():
        model.eval()
        with torch.inference_mode():
            fwd[name] = cuda_ms(lambda: model(x, g), iters=5)
        stp[name] = cuda_ms(lambda: steps[name](x, g, y, mask), iters=3, warmup=1)
        log(f"{card} {name} over the bucketed route: forward {fwd[name]:.4f} ms (request wall "
            f"{min(req_s[name]) * 1e3:.4f} ms min), training step {stp[name]:.4f} ms")

    # 34. max and prod on the card (the plain route: segment_reduce over the
    # dst-sorted runs) against the CPU's, reruns bit-identical
    arm("bucket_reduce")
    cpu_g = dataclasses.replace(g, src=g.src.cpu(), dst=g.dst.cpu(),
                                edge_weight=g.edge_weight.cpu())
    deg = torch.bincount(g.dst.long(), minlength=n).cpu()
    xr = torch.randn(n, 16, generator=gen, device=dev)
    xp = 1.0 + 1e-3 * torch.randn(n, 16, generator=gen, device=dev)
    ones = torch.ones(nnz, device=dev)
    red_ms = {}
    for reduce, xx, w in (("max", xr, None), ("prod", xp, ones)):
        if api.dispatch_path(g, reduce=reduce) != "xla":
            raise AssertionError(f"reduce={reduce} does not take the plain route")
        k = api.segment_spmm(g, xx, w, reduce=reduce)
        torch.cuda.synchronize()
        for _ in range(2):
            if not torch.equal(api.segment_spmm(g, xx, w, reduce=reduce), k):
                raise AssertionError(f"phase 34 segment_spmm {reduce}: not deterministic")
        p = api.segment_spmm(cpu_g, xx.cpu(), None if w is None else w.cpu(), reduce=reduce)
        what = f"phase 34 segment_spmm reduce={reduce} F=16 (card vs CPU)"
        if reduce == "max":
            if not torch.equal(k.cpu(), p):
                raise AssertionError(f"{what}: max differs")
            log(f"{what}: equal")
        else:
            prod_close(k.cpu(), p, deg, what)
        red_ms[reduce] = cuda_ms(lambda: api.segment_spmm(g, xx, w, reduce=reduce), iters=5)
        log(f"{card} segment_spmm reduce={reduce} F=16 (plain route) {red_ms[reduce]:.4f} ms")
    log("phase 34 max and prod reruns bit-identical (three runs each)")
    del cpu_g, xr, xp, ones, k, p

    # 35. save_graph / load_graph of the bucketed graph: loaded on the card
    # with its schedules, and a request through it bit-identical
    arm("bucket_cache")
    tmp = tempfile.mkdtemp(prefix="geot_graph_")
    try:
        path = os.path.join(tmp, "arxiv_bucketed.npz")
        t0 = time.perf_counter()
        save_graph(g, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        g2 = load_graph(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if g2 is None or not g2.src.is_cuda or not g2.bat_b.row_sched.cols.is_cuda:
        raise AssertionError("load_graph did not give the graph back on the card")
    if row_schedule_of(g2.bat_b) is not g2.bat_b.row_sched:
        raise AssertionError("the loaded bucketed plan's schedule was rebuilt")
    model = models["gcn"].eval()
    with torch.inference_mode():
        a, b = model(x, g), model(x, g2)
    if not torch.equal(a, b):
        raise AssertionError("a request through the loaded graph differs from the built one")
    log(f"phase 35 save_graph {save_s:.2f}s ({size / 1e6:.1f} MB), load_graph {load_s:.2f}s "
        f"on the card beside the build's {build_s:.2f}s; a request through the loaded graph "
        "bit-identical to the built one")
    faulthandler.cancel_dump_traceback_later()
    return {"serve": serve, "train": train, "err": err, "timing": timing, "losses": losses,
            "forward_ms": fwd, "train_step_ms": stp, "reduce_ms": red_ms, "build_s": build_s,
            "load_s": load_s, "save_s": save_s, "file_mb": size / 1e6, "graph": g,
            "c19": c19}


def kernel_counters():
    """{name: wrapper} of every kernel wrapper that counts its launches."""
    from geot_tpu_torch.ops import COUNTED_KERNELS

    return dict(COUNTED_KERNELS)


def launches_of(fn, counters):
    """(fn(), {kernel: launches during fn}) with every count set to 0 first."""
    for k in counters.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in counters.items()}


def same_tensors(a, b, what):
    """Every tensor and static of two graphs (or plans) equal; host seconds
    and build_stats aside."""
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    elif dataclasses.is_dataclass(a):
        if type(a) is not type(b):
            raise AssertionError(f"{what}: {type(a).__name__} vs {type(b).__name__}")
        for fld in dataclasses.fields(a):
            if fld.name not in ("build_stats", "seconds"):
                same_tensors(getattr(a, fld.name), getattr(b, fld.name), f"{what}.{fld.name}")
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths {len(a)} vs {len(b)}")
        for i, (u, v) in enumerate(zip(a, b)):
            same_tensors(u, v, f"{what}.{i}")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} vs {b!r}")


def run_native(dev, data):
    """Phase 36: the native host runtime built and loaded; the arxiv graph's
    plans built through it and through numpy, equal, with both host times."""
    import numpy as np

    from geot_tpu_torch import native
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES
    from geot_tpu_torch.models import prepare_graph

    arm("native")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native runtime did not build or load (g++)")
    log(f"phase 36 native runtime built and loaded in {time.perf_counter() - t0:.2f}s "
        f"({native._lib_path().name})")
    n = DATASET_SHAPES["ogbn-arxiv"][0]
    kw = dict(layouts=("bat", "slot"), normalize="gcn", bucket_table_bytes=1, device=dev)
    built, secs = {}, {}
    for how in ("native", "numpy"):
        t0 = time.perf_counter()
        if how == "native":
            g = prepare_graph(data.src, data.dst, n, **kw)
        else:
            with native.disabled():
                g = prepare_graph(data.src, data.dst, n, **kw)
        torch.cuda.synchronize()
        secs[how] = time.perf_counter() - t0
        built[how] = g
        log(f"phase 36 arxiv graph through {how}: prepare_graph {secs[how]:.2f}s; steps "
            + ", ".join(f"{k} {v:.2f}s" for k, v in g.build_stats["seconds"].items())
            + "; edge-row schedules " + ", ".join(
                f"{k} {v['seconds']:.3f}s" for k, v in g.build_stats["row_schedule"].items()))
    same_tensors(built["native"], built["numpy"], "phase 36 graph")
    dst = np.sort(data.dst).astype(np.int32)
    want = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    if not np.array_equal(native.coo_to_csr_host(dst, n), want):
        raise AssertionError("phase 36 coo_to_csr_host differs from numpy")
    log(f"phase 36 every plan array equal (slot plans at pack_align 1, BAT, bucketed BAT, both "
        f"sorts); host build native {secs['native']:.2f}s, numpy {secs['numpy']:.2f}s")
    return secs


def run_tuning(dev, card, data, g30):
    """Phase 37: the tuning sweep on the card (the fast space, arxiv, F 128
    and 40, spmm and spmm_dyn) into a temporary table; select_config and
    build_graph under it; an empty table gives phase 30's graph."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_clustered_graph
    from geot_tpu_torch.graph.structures import _table_knobs, build_graph
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.tuning import heuristics as H
    from geot_tpu_torch.tuning import sweep

    arm("tune")
    counters = kernel_counters()
    n, e, _, c = DATASET_SHAPES["ogbn-arxiv"]
    feats, ops = (128, c), ("spmm", "spmm_dyn")
    tmp = tempfile.mkdtemp(prefix="geot_tune_")
    old_env = os.environ.pop(H.TABLE_ENV, None)
    try:
        table = os.path.join(tmp, "table.json")
        t0 = time.perf_counter()
        (best, rows), launches = launches_of(lambda: sweep.sweep_graph(
            "ogbn-arxiv", data.src, data.dst, n, list(feats), ops=ops, iters=20,
            verbose=False, out_path=table, fast=True, device=dev), counters)
        sweep_s = time.perf_counter() - t0
        for r in rows:
            log(f"{card} phase 37 sweep {r.op} F={r.n_features} {r.cfg.key()}: "
                f"{r.seconds * 1e3:.4f} ms")
        for op in ops:
            for F in feats:
                want = [cfg for cfg in sweep.config_space(op, F, fast=True)
                        if cfg.mode != "hybrid"]
                got = [r.cfg for r in rows if r.op == op and r.n_features == F]
                missing = [cfg.key() for cfg in want if cfg not in got]
                if missing:
                    raise AssertionError(f"phase 37 {op} F={F}: not measured {missing}")
        hyb = [r for r in rows if r.cfg.mode == "hybrid"]
        log(f"phase 37 sweep: {len(rows)} configurations in {sweep_s:.1f}s, launches "
            f"{ {k: v for k, v in launches.items() if v} }; hybrid on arxiv: "
            + (f"{hyb[0].seconds * 1e3:.4f} ms" if hyb else "inapplicable (the census does "
                                                           "not stream this graph)"))
        # the hybrid candidate on an arxiv-size graph of small communities,
        # which the census streams in both directions
        dc = synthetic_clustered_graph(n, e, mixing=0.02, mean_community=32, power=1.0,
                                       seed=SEED)
        t_hyb, hyb_launch = launches_of(lambda: sweep.measure_config(
            H.KernelConfig("hybrid"), dc.src, dc.dst, n, 128, iters=20, device=dev), counters)
        if t_hyb is None:
            raise AssertionError("phase 37: the hybrid candidate did not run on the clustered "
                                 "graph")
        expect_launches(hyb_launch["stream_segment_sum"] > 0, True,
                        "phase 37 hybrid candidate: stream_segment_sum launched")
        launches["hybrid_clustered"] = {k: v for k, v in hyb_launch.items() if v}
        log(f"{card} phase 37 hybrid candidate, arxiv-size clustered graph ({dc.num_edges} "
            f"edges) F=128: {t_hyb * 1e3:.4f} ms; launches {launches['hybrid_clustered']}")

        os.environ[H.TABLE_ENV] = table
        nnz = len(data.src)
        for op in ops:
            for F in feats:
                kb = f"{op}:{H.bucket_key(F, nnz, n)}"
                got, source = H.select_config_ex(F, nnz, n, op=op)
                if got != best[kb][0] or source != "table":
                    raise AssertionError(f"phase 37 select_config {kb}: {got} ({source}), "
                                         f"measured winner {best[kb][0]}")
        log("phase 37 select_config under the swept table: each bucket's measured winner ("
            + ", ".join(f"{k} {v[0].key()} {v[1] * 1e3:.4f} ms" for k, v in best.items()) + ")")
        gen = torch.Generator(device=dev).manual_seed(SEED + 37)
        w_np = np.random.default_rng(SEED).random(nnz).astype(np.float32)
        for F in feats:
            knobs, unpack = _table_knobs(F, nnz, n)
            g = build_graph(data.src, data.dst, n, edge_weight=w_np, feature_hint=F,
                            layouts=("bat", "slot"), device=dev)
            built = dict(e_tile=g.plan.e_tile, s_tile=g.plan.s_tile, mode_hint=g.plan.mode_hint,
                         bat_e_tile=g.bat.e_tile, bat_s_tile=g.bat.s_tile, prefer=g.prefer,
                         prefer_dyn=g.prefer_dyn)
            for k, v in knobs.items():
                if built[k] != v:
                    raise AssertionError(f"phase 37 F={F}: {k} {built[k]}, the table says {v}")
            xf = torch.randn(n, F, generator=gen, device=dev)
            wd = torch.rand(nnz, generator=gen, device=dev)
            for label, w in (("graph weights", None), ("per-call weights", wd)):
                out = api.segment_spmm(g, xf, w)
                ww = g.edge_weight if w is None else w
                p = ref_ops.gather_weight_scatter_ref(g.src, g.dst, ww, xf, n)
                a = ref_ops.gather_weight_scatter_ref(g.src, g.dst, ww.abs(), xf.abs(), n)
                check_close_abs_sum(out, p, a, f"phase 37 F={F} {label} under the table "
                                    f"(route {api.dispatch_path(g, dynamic_w=w is not None)})")
            log(f"phase 37 build_graph F={F} under the table: knobs {built} (the table's "
                f"{knobs}, unpacked BAT {unpack}; km_pack {g.bat.km_pack})")
            del g, xf, wd
        empty = os.path.join(tmp, "empty.json")
        with open(empty, "w") as fh:
            fh.write("{}")
        os.environ[H.TABLE_ENV] = empty
        g_e = prepare_graph(data.src, data.dst, n, layouts=("bat",), normalize="gcn",
                            bucket_table_bytes=1, device=dev)
        same_tensors(g_e, g30, "phase 37 empty-table graph vs phase 30's")
        log("phase 37 an empty table: prepare_graph's plans equal phase 30's build")
    finally:
        os.environ.pop(H.TABLE_ENV, None)
        if old_env is not None:
            os.environ[H.TABLE_ENV] = old_env
        shutil.rmtree(tmp, ignore_errors=True)
    faulthandler.cancel_dump_traceback_later()
    return {"rows": [dict(op=r.op, F=r.n_features, config=r.cfg.key(), ms=r.seconds * 1e3)
                     for r in rows],
            "best": {k: [v[0].key(), v[1] * 1e3] for k, v in best.items()},
            "hybrid_clustered_ms": t_hyb * 1e3, "launches": launches, "sweep_s": sweep_s}


def run_compiler(dev, card, g, x):
    """Phase 38: the compiler pass over a two-layer GCN written in plain
    PyTorch on the arxiv graph, and the multi-head pattern on the GAT
    graph: matches, outputs against the unrewritten function and float64,
    the kernels' launches, timings."""
    from geot_tpu_torch.compiler import count_matches, pattern_transform
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.models import gcn_edge_weight
    from geot_tpu_torch.profile_gcn import flickr_graph

    arm("compiler")
    counters = kernel_counters()
    n, c = g.num_nodes, DATASET_SHAPES["ogbn-arxiv"][3]
    src, dst = g.src, g.dst
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    w1 = (torch.randn(x.shape[1], 128, generator=gen, device=dev) * 0.1).requires_grad_()
    w2 = (torch.randn(128, c, generator=gen, device=dev) * 0.1).requires_grad_()
    ew = gcn_edge_weight(g).detach().requires_grad_()

    def agg(h, ew):
        return torch.zeros(n, h.shape[1], dtype=h.dtype, device=h.device).index_add_(
            0, dst, h.index_select(0, src) * ew[:, None])

    def gcn2(x, ew, w1, w2):
        return agg(torch.relu(agg(x @ w1, ew)) @ w2, ew)

    args = (x, ew, w1, w2)
    matches = count_matches(gcn2, g, *args)
    if matches != 2:
        raise AssertionError(f"phase 38 count_matches {matches}, expected 2")
    fused = pattern_transform(gcn2, g)
    t0 = time.perf_counter()
    out, fwd = launches_of(lambda: fused(*args), counters)
    trace_s = time.perf_counter() - t0
    fwd = {k: v for k, v in fwd.items() if v}
    expect_launches(fwd, {"bat_segment_sum": 2}, "phase 38 rewritten forward")
    with torch.no_grad():
        plain = gcn2(*args)
        d64 = [a.detach().double() for a in args]
        ref64 = gcn2(*d64).float()
        absum = gcn2(*[a.abs() for a in d64]).float()
    err_p = check_close_abs_sum(out.detach(), plain, absum,
                                "phase 38 rewritten GCN vs the unrewritten function")
    err_64 = check_close_abs_sum(out.detach(), ref64, absum, "phase 38 rewritten GCN vs float64")
    cot = torch.randn(out.shape, generator=gen, device=dev)
    grads, bwd = launches_of(lambda: torch.autograd.grad((out * cot).sum(), (ew, w1, w2)),
                             counters)
    bwd = {k: v for k, v in bwd.items() if v}
    expect_launches(bwd, {"bat_segment_sum": 2, "sddmm_bat": 2},
                    "phase 38 rewritten backward (the transpose sums and dw)")
    want = torch.autograd.grad((gcn2(*args) * cot).sum(), (ew, w1, w2))
    # the oracle: the unrewritten function in float64 (as phases 12 and 32,
    # ROADMAP C.7, C.21: the f32 one sums arxiv's hub rows with
    # index_add_'s atomics in any order) through the rewritten path's own
    # ReLU pattern (phase 18's rule, C.10: a hidden pre-activation within
    # rounding of 0 may take the other sign in float64, and relu' then
    # differs there by the whole upstream gradient)
    with torch.no_grad():
        z_kernel = pattern_transform(lambda x, ew, w1: agg(x @ w1, ew), g)(x, ew, w1)
    a64 = [a.detach().double().requires_grad_(a.requires_grad) for a in args]
    z64 = agg(a64[0] @ a64[2], a64[1])
    flips = relu_flips([z_kernel], [z64.detach().float()], "phase 38 (float64 oracle)")
    out64 = agg((z64 * (z_kernel > 0)) @ a64[3], a64[1])
    want64 = torch.autograd.grad((out64 * cot.double()).sum(), a64[1:])
    gerr = {}
    for name, a, b, h in zip(("ew", "w1", "w2"), grads, want, want64):
        h = h.float()
        gerr[name] = (float((a - h).abs().max()), float((b - h).abs().max()))
        torch.testing.assert_close(a, h, rtol=GRAD_RTOL, atol=GRAD_RTOL * float(h.abs().max()),
                                   msg=lambda m: f"phase 38 gradient {name}: {m}")
    del a64, z64, out64, want64, z_kernel
    fused(*args)
    if len(fused.cache) != 1:
        raise AssertionError("phase 38: a second call with the same shapes traced again")
    log(f"phase 38 two-layer GCN in plain PyTorch (index_select -> mul -> index_add_): "
        f"count_matches 2; first call (trace + rewrite + run) {trace_s:.2f}s; forward "
        f"launches {fwd.get('bat_segment_sum', 0)} bat_segment_sum, backward "
        f"{bwd.get('bat_segment_sum', 0)} bat_segment_sum (over bat_t) + "
        f"{bwd.get('sddmm_bat', 0)} sddmm_bat; "
        f"max |err| vs the unrewritten function {err_p:.3e}, vs float64 {err_64:.3e}; "
        f"gradients against float64 through the rewritten path's ReLU pattern ({flips[0]} "
        f"flip(s), the largest at {flips[1]:.2e} * max|z|) within phase 8's rule (max "
        "|rewritten - f64|, max |unrewritten f32 (its own ReLU pattern) - f64|): "
        + ", ".join(f"{k} ({u:.3e}, {v:.3e})" for k, (u, v) in gerr.items()))
    with torch.no_grad():
        t_fused = cuda_ms(lambda: fused(*args))
        t_plain = cuda_ms(lambda: gcn2(*args))

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad((fn(*args) * cot).sum(), (ew, w1, w2))

    t_fused_step, t_plain_step = cuda_ms(fwd_bwd(fused)), cuda_ms(fwd_bwd(gcn2))
    log(f"{card} phase 38 GCN forward: rewritten {t_fused:.4f} ms, unrewritten {t_plain:.4f} ms; "
        f"forward + backward: rewritten {t_fused_step:.4f} ms, unrewritten {t_plain_step:.4f} ms")
    del out, plain, ref64, absum, grads, want

    # the multi-head pattern on the GAT graph (flickr, slot plans)
    nf, ef, ff, _ = DATASET_SHAPES["flickr"]
    data = synthetic_graph(nf, ef, power=1.0, feat_dim=8, num_classes=2, seed=SEED)
    gg = flickr_graph(data, "gat", dev)
    H, D, e_g = 4, 64, gg.num_edges
    xh = torch.randn(nf, H, D, generator=gen, device=dev).requires_grad_()
    att = torch.rand(e_g, H, generator=gen, device=dev).requires_grad_()
    s_g, d_g = gg.src, gg.dst

    def mh(xh, att):
        return torch.zeros(nf, H, D, device=xh.device).index_add_(
            0, d_g, xh[s_g] * att.unsqueeze(-1))

    if count_matches(mh, gg, xh, att) != 1:
        raise AssertionError("phase 38: the multi-head pattern did not match")
    fused_mh = pattern_transform(mh, gg)
    out, fwd_mh = launches_of(lambda: fused_mh(xh, att), counters)
    fwd_mh = {k: v for k, v in fwd_mh.items() if v}
    expect_launches(fwd_mh, {"plan_segment_sum_mh": 1}, "phase 38 multi-head forward")
    with torch.no_grad():
        plain = mh(xh, att)
        absum = mh(xh.abs(), att.abs())
    err_mh = check_close_abs_sum(out.detach(), plain, absum,
                                 "phase 38 multi-head rewritten vs unrewritten")
    cot = torch.randn(out.shape, generator=gen, device=dev)
    _, bwd_mh = launches_of(lambda: torch.autograd.grad((out * cot).sum(), (xh, att)), counters)
    bwd_mh = {k: v for k, v in bwd_mh.items() if v}
    expect_launches(bwd_mh, {"plan_segment_sum_mh": 1, "edge_dots": 1},
                    "phase 38 multi-head backward")
    with torch.no_grad():
        t_mh, t_mh_plain = cuda_ms(lambda: fused_mh(xh, att)), cuda_ms(lambda: mh(xh, att))
    log(f"{card} phase 38 multi-head (flickr GAT graph, {e_g} edges, H*D {H * D}): launches "
        f"forward {fwd_mh.get('plan_segment_sum_mh', 0)} plan_segment_sum_mh, backward "
        f"{bwd_mh.get('plan_segment_sum_mh', 0)} plan_segment_sum_mh (over plan_t) + "
        f"{bwd_mh.get('edge_dots', 0)} edge_dots; max |err| {err_mh:.3e}; rewritten {t_mh:.4f} ms, "
        f"unrewritten {t_mh_plain:.4f} ms")
    faulthandler.cancel_dump_traceback_later()
    return {"launches": {"compiler_gcn_forward": fwd, "compiler_gcn_backward": bwd,
                         "compiler_mh_forward": fwd_mh, "compiler_mh_backward": bwd_mh},
            "gcn_forward_ms": t_fused, "gcn_forward_unrewritten_ms": t_plain,
            "gcn_step_ms": t_fused_step, "gcn_step_unrewritten_ms": t_plain_step,
            "mh_ms": t_mh, "mh_unrewritten_ms": t_mh_plain,
            "max_abs_err": max(err_p, err_mh)}


def check_c19(c19):
    """Phase 39: the norm variants' step-0 gradients of phase 32 held per
    tensor against float64 (ROADMAP C.19): the kernel path's relative
    distance ||g - g64|| / ||g64|| at most twice the f32 reference path's."""
    arm("c19")
    out = {}
    for name, (kern, ref32, g64) in c19.items():
        model = max(float(h.abs().max()) for h in g64.values())
        rows, worst = [], 0.0
        for k, h in g64.items():
            norm = max(float(h.norm()), 1e-12 * model)
            e_k = float((kern[k].double() - h).norm()) / norm
            e_r = float((ref32[k].double() - h).norm()) / norm
            if not e_k <= 2 * e_r:
                raise AssertionError(f"phase 39 {name} {k}: relative distance from float64 "
                                     f"{e_k:.3e}, past twice the f32 reference path's {e_r:.3e}")
            rows.append((k, e_k, e_r))
            worst = max(worst, e_k / e_r if e_r else 0.0)
        out[name] = {"worst_ratio": worst, "tensors": {k: [e_k, e_r] for k, e_k, e_r in rows}}
        log(f"phase 39 {name} step 0 gradients per tensor against float64 (||kernel - f64|| / "
            "||f64||, ||f32 reference - f64|| / ||f64||): "
            + ", ".join(f"{k} ({a:.2e}, {b:.2e})" for k, a, b in rows)
            + f"; worst kernel / reference {worst:.3f} (limit 2)")
    faulthandler.cancel_dump_traceback_later()
    return out


def partition_stats(pg):
    """(interior share of the edges, tiles, chunks) of a partition: the
    slot plans' live slots and tiles, or the BAT and stream families'
    live edges, tiles and chunk counts (boundary, interior, boundary_t,
    interior_t, then the stream families)."""
    if pg.plan is not None:
        fams = (pg.plan, pg.plan_int, pg.plan_t, pg.plan_int_t)
        live = [int((f.mask != 0).sum()) for f in fams]
        tiles = [int(f.out_block.shape[1]) for f in fams]
        chunks = [1] * 4
    else:
        fams = (pg.bat, pg.bat_int, pg.bat_t, pg.bat_int_t)
        live = [int((f.dst3 >= 0).sum()) for f in fams]
        tiles = [f.C * f.T_c for f in fams]
        chunks = [f.C for f in fams]
        if pg.stream_int is not None:
            live[1] += int((pg.stream_int.dst3 >= 0).sum())
        for s in (pg.stream_int, pg.stream_int_t):
            if s is not None:
                tiles.append(s.C * s.T_c)
                chunks.append(s.C)
    return live[1] / max(live[0] + live[1], 1), tiles, chunks


PARTITIONS = (("slot2", "arxiv", 2, "auto"), ("slot4", "arxiv", 4, "auto"),
              ("bat2", "arxiv", 2, "bat"), ("bat4", "arxiv", 4, "bat"),
              ("hybrid2", "clustered", 2, "hybrid"))


def run_partition(g, w_gcn, n, e):
    """Phase 40: partition the arxiv graph (the GCN norm of the whole
    graph as edge weights) into 2 and 4 parts by layout "auto" (which must
    pick the slot layout) and "bat", and an arxiv-size clustered graph
    (phase 37's: communities of 32, mixing 0.02; self-loops and the GCN
    norm) into 2 parts by "hybrid", whose census must stream; each one's
    seconds, halo, interior share, tiles and chunks. Returns ({label: pg},
    {graph: (src, dst, w) numpy}, stats)."""
    from geot_tpu_torch.graph.datasets import synthetic_clustered_graph
    from geot_tpu_torch.graph.preprocess import gcn_norm
    from geot_tpu_torch.parallel import partition_graph

    arm("par_build")
    dc = synthetic_clustered_graph(n, e, mixing=0.02, mean_community=32, power=1.0, seed=SEED)
    graphs = {"arxiv": (g.src.cpu().numpy(), g.dst.cpu().numpy(), w_gcn.cpu().numpy()),
              "clustered": tuple(t.numpy() for t in gcn_norm(dc.src, dc.dst, n))}
    pgs, stats = {}, {}
    for label, gname, P, layout in PARTITIONS:
        src, dst, w = graphs[gname]
        t0 = time.perf_counter()
        pg = partition_graph(src, dst, n, P, edge_weight=w, layout=layout)
        secs = time.perf_counter() - t0
        want = "slot" if layout == "auto" else layout
        if pg.layout != want:
            raise AssertionError(f"phase 40 {label}: layout {pg.layout}, expected {want}")
        if want == "hybrid" and (pg.stream_int is None or pg.stream_int_t is None):
            raise AssertionError(f"phase 40 {label}: the census streamed no interior cells")
        share, tiles, chunks = partition_stats(pg)
        pgs[label] = pg
        stats[label] = dict(seconds=secs, halo=pg.halo, nodes_per_part=pg.nodes_per_part,
                            edges=len(src), interior_share=share, tiles=tiles, chunks=chunks)
        log(f"phase 40 {label} ({gname}, layout {layout!r} -> {pg.layout}): partition_graph "
            f"{secs:.2f}s, {len(src)} edges, nodes_per_part {pg.nodes_per_part}, halo H="
            f"{pg.halo} ({P * pg.halo} receive rows a part), interior share {share:.4f}, "
            f"tiles (boundary, interior, boundary_t, interior_t{', streams' * (want == 'hybrid')}"
            f") {tiles}, chunks {chunks}")
    faulthandler.cancel_dump_traceback_later()
    return pgs, graphs, stats


def run_part_reduces(dev, pgs):
    """Phase 41: every part's reduces of every partition of phase 40 on the
    card against their plain versions, both directions, at F 128 and 40:
    the slot plans' sr / sr_packed (x[src[e]] read in the edge-row
    kernel), the BAT families' bat_segment_sum and the streamed cells'
    stream_segment_sum / _acc; the abs-sum rule; each reduce one launch
    of its kernel; three reruns bit-identical. Returns (max error per
    kernel, views' build seconds)."""
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum_plain
    from geot_tpu_torch.ops.reference import plan_segment_sum_sr_plain
    from geot_tpu_torch.ops.stream_kernels import (
        stream_segment_acc_plain,
        stream_segment_sum_plain,
    )
    from geot_tpu_torch.parallel.bat_partition import PartBat, part_bat_reduce
    from geot_tpu_torch.parallel.halo_spmm import part_slot_reduce
    from geot_tpu_torch.parallel.stream_partition import part_stream_reduce

    arm("par_kernel")
    counters = kernel_counters()
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    errs, n_checks, view_s = {}, 0, 0.0

    def held(name, run, plain, plain_abs, what):
        nonlocal n_checks
        k, launches = launches_of(run, counters)
        expect_launches({c: v for c, v in launches.items() if v}, {name: 1}, what)
        err = check_close_abs_sum(k, plain(), plain_abs(), what)
        errs[name] = max(errs.get(name, 0.0), err)
        for _ in range(3):
            if not torch.equal(run(), k):
                raise AssertionError(f"{what}: a rerun differs")
        n_checks += 1

    for label, pg in pgs.items():
        P, H, npp = pg.num_parts, pg.halo, pg.nodes_per_part
        for r in range(P):
            t0 = time.perf_counter()
            view = pg.part(r, dev)
            torch.cuda.synchronize()
            view_s += time.perf_counter() - t0
            for F in (128, 40):
                for fam_name in ("boundary", "interior", "boundary_t", "interior_t"):
                    fam = getattr(view, fam_name)
                    rows = P * H if fam_name == "boundary" else npp
                    x = torch.randn(rows, F, generator=gen, device=dev)
                    what = f"phase 41 {label} part {r} {fam_name} F={F}"
                    if isinstance(fam, PartBat):
                        bp, m = fam.plan, fam.plan.num_segments
                        w_abs = None if fam.w is None else fam.w.abs()
                        held("bat_segment_sum", lambda: part_bat_reduce(fam, x),
                             lambda: bat_segment_sum_plain(bp, x, fam.w, src=fam.src)[:m],
                             lambda: bat_segment_sum_plain(bp, x.abs(), w_abs, src=fam.src)[:m],
                             what)
                    else:
                        pl, m = fam.plan, fam.plan.num_segments
                        name = "plan_segment_sum_sr" if F > 64 else "plan_segment_sum_sr_packed"
                        held(name, lambda: part_slot_reduce(fam, x),
                             lambda: plan_segment_sum_sr_plain(pl, x, fam.w, src=fam.src)[:m],
                             lambda: plan_segment_sum_sr_plain(pl, x.abs(), fam.w.abs(),
                                                               src=fam.src)[:m], what)
                for sp, tag in ((view.stream, "stream"), (view.stream_t, "stream_t")):
                    if sp is None:
                        continue
                    x = torch.randn(npp, F, generator=gen, device=dev)
                    carry = torch.randn(sp.n_blocks * sp.s_tile, F, generator=gen, device=dev)
                    w_abs = dataclasses.replace(sp, vals=None if sp.vals is None
                                                else sp.vals.abs(),
                                                w3=None if sp.w3 is None else sp.w3.abs())
                    what = f"phase 41 {label} part {r} {tag} F={F}"
                    held("stream_segment_sum", lambda: part_stream_reduce(sp, x),
                         lambda: stream_segment_sum_plain(sp, x),
                         lambda: stream_segment_sum_plain(w_abs, x.abs()), what + " sum")
                    held("stream_segment_acc",
                         lambda: part_stream_reduce(sp, x, carry=carry.clone()),
                         lambda: stream_segment_acc_plain(sp, x, carry.clone()),
                         lambda: stream_segment_acc_plain(w_abs, x.abs(), carry.abs()),
                         what + " acc")
            del view
    log(f"phase 41 {n_checks} part-local reduces on the card, each one launch of its kernel, "
        f"within the abs-sum rule of their plain versions, three reruns each bit-identical; max errors {errs}; the parts' views "
        f"(plans, schedules, halo indices moved once) built in {view_s:.2f}s")
    faulthandler.cancel_dump_traceback_later()
    return errs, view_s


def gcn_dense(params, x, src, dst, w, n, dtype, masks=None):
    """The GCN of `dist_train.gcn_forward` on the whole graph in `dtype`
    (plain index_add_ sums): (output, hidden pre-activations); with
    `masks` the ReLU takes their pattern."""
    h, zs = x.to(dtype), []
    L = len(params) // 2
    for i in range(L):
        h = h @ params[f"w{i}"].to(dtype)
        h = torch.zeros(n, h.shape[1], dtype=dtype, device=h.device).index_add_(
            0, dst, h.index_select(0, src) * w.to(dtype)[:, None]) + params[f"b{i}"].to(dtype)
        if i + 1 < L:
            zs.append(h)
            h = torch.relu(h) if masks is None else h * masks[i].to(dtype)
    return h, zs


def masked_nll(logits, y, m, count):
    return (torch.nn.functional.cross_entropy(logits, y, reduction="none") * m).sum() / count


def parallel_rank(rank, world, job):
    """Phase 42 on one rank of a gloo group, a spawned process on cuda:0:
    halo_spmm forward and x gradient per layout against the same rank on
    the reference backend and the whole graph's SpMM in float64; 5
    requests and 5 Adam steps of the GCN over the slot partition against
    float64; timings; rank 0 also runs halo_spmm over a 1-part partition
    in a 1-rank NCCL group. Returns its results (numbers only)."""
    import torch.distributed as dist

    from geot_tpu_torch.parallel import (
        block_nodes,
        gcn_forward,
        halo_spmm,
        init_gcn_params,
        make_dist_train_step,
        node_sharding,
        partition_graph,
        shard_inputs,
        unblock_nodes,
    )
    from geot_tpu_torch.parallel.halo_spmm import _interior_reduce

    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    # NCCL at world size 1 (rank 0's own group; every rank takes part in
    # making it): NCCL takes one rank a card
    nccl = dist.new_group([0], backend="nccl") if dev.type == "cuda" else None
    counters = kernel_counters()
    n = job["n"]
    res = {"rank": rank, "halo": {}, "launches": {}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    F = 128

    def dense(edges):
        s, d, w = (torch.from_numpy(a).to(dev) for a in edges)
        return s.long(), d.long(), w.double()

    def spmm64(x, s, d, w):
        out = torch.zeros(n, x.shape[1], dtype=torch.float64, device=dev)
        return out.index_add_(0, d, x.double().index_select(0, s) * w[:, None])

    views = {}
    for layout, gname in (("slot", "arxiv"), ("bat", "arxiv"), ("hybrid", "clustered")):
        t0 = time.perf_counter()
        edges = job["graphs"][gname]
        pg = partition_graph(*edges[:2], n, world, edge_weight=edges[2], layout=layout)
        view = pg.part(rank, dev)
        views[layout] = (pg, view)
        build_s = time.perf_counter() - t0
        s, d, w = dense(edges)
        rows = node_sharding(pg, rank)
        x = torch.randn(n, F, generator=gen, device=dev)
        cot = torch.randn(n, F, generator=gen, device=dev)
        xl, cl = block_nodes(x, pg)[rows].contiguous(), block_nodes(cot, pg)[rows].contiguous()

        def run(backend):
            xx = xl.clone().requires_grad_()
            out = halo_spmm(xx, view, backend=backend)
            (out * cl).sum().backward()
            return out.detach(), xx.grad

        (out, grad), launches = launches_of(lambda: run("auto"), counters)
        launches = {k: v for k, v in launches.items() if v}
        streams = (view.stream is not None) + (view.stream_t is not None)
        want = {"slot": {"plan_segment_sum_sr": 4}, "bat": {"bat_segment_sum": 4},
                "hybrid": {"bat_segment_sum": 4, "stream_segment_acc": streams}}[layout]
        expect_launches(launches, {k: v for k, v in want.items() if v},
                        f"phase 42 rank {rank} {layout} forward + x gradient")
        out_r, grad_r = run("reference")
        out2, grad2 = run("auto")
        if not (torch.equal(out2, out) and torch.equal(grad2, grad)):
            raise AssertionError(f"phase 42 rank {rank} {layout}: a rerun differs")
        blk = lambda t: block_nodes(t, pg)[rows]  # noqa: E731
        o64, oabs = spmm64(x, s, d, w), spmm64(x.abs(), s, d, w.abs())
        g64, gabs = spmm64(cot, d, s, w), spmm64(cot.abs(), d, s, w.abs())
        what = f"phase 42 rank {rank} {layout}"
        err = {
            "out_vs_f64": check_close_abs_sum(out, blk(o64).float(), blk(oabs).float(),
                                              what + " forward vs float64"),
            "out_vs_reference": check_close_abs_sum(out, out_r, blk(oabs).float(),
                                                    what + " forward vs reference backend"),
            "grad_vs_f64": check_close_abs_sum(grad, blk(g64).float(), blk(gabs).float(),
                                               what + " x gradient vs float64"),
            "grad_vs_reference": check_close_abs_sum(grad, grad_r, blk(gabs).float(),
                                                     what + " x gradient vs reference backend"),
        }
        width = pg.part_start[rank + 1] - pg.part_start[rank]
        if bool(out[width:].any()):
            raise AssertionError(f"{what}: a blocked pad row is not 0")
        res["halo"][layout] = dict(err=err, build_s=build_s, halo=pg.halo, launches=launches)
        del x, cot, o64, oabs, g64, gabs, s, d, w

    # the GCN over the 2-part slot partition, phases 1-9's widths
    pg, view = views["slot"]
    s, d, w = dense(job["graphs"]["arxiv"])
    dims = [job["x"].shape[1], 128, 128, job["classes"]]
    params = init_gcn_params(dims, generator=torch.Generator(device=dev).manual_seed(SEED + 43),
                             device=dev)
    x, y, m = shard_inputs(job["x"], job["y"], job["train_mask"], pg, rank, dev)
    y, mf = y.long(), m.float()
    xg = torch.from_numpy(job["x"]).to(dev)
    yg = torch.from_numpy(job["y"]).to(dev).long()
    mg = torch.from_numpy(job["train_mask"]).to(dev).double()
    rows = node_sharding(pg, rank)
    per_request = {"plan_segment_sum_sr": 4, "plan_segment_sum_sr_packed": 2}
    per_step = {k: 2 * v for k, v in per_request.items()}
    req_s, req_err, serve = [], 0.0, {}
    with torch.no_grad():
        ref = block_nodes(gcn_dense(params, xg, s, d, w, n, torch.float64)[0], pg)[rows]
        for i in range(REQUESTS):
            ts = time.perf_counter()
            out, launches = launches_of(lambda: gcn_forward(params, x, view), counters)
            req_s.append(time.perf_counter() - ts)
            expect_launches({k: v for k, v in launches.items() if v}, per_request,
                            f"phase 42 rank {rank} request {i}")
            serve = {k: serve.get(k, 0) + v for k, v in launches.items() if v}
            if out.shape != (pg.nodes_per_part, dims[-1]) or not torch.isfinite(out).all():
                raise AssertionError(f"phase 42 rank {rank} request {i}: bad output")
            torch.testing.assert_close(out, ref.float(), **MODEL_TOL)
            req_err = max(req_err, float((out.double() - ref).abs().max()))
    res["launches"]["serve"] = serve

    # step 0's gradients against float64 through the kernel path's ReLU
    # pattern (gathered from both ranks over the CPU), as phase 18
    with torch.no_grad():
        h, z_kernel = x, []
        for i in range(len(dims) - 1):
            h = halo_spmm(h @ params[f"w{i}"], view) + params[f"b{i}"]
            if i + 2 < len(dims):
                z_kernel.append(h)
                h = torch.relu(h)
    masks = []
    for z in z_kernel:
        parts = [torch.empty(z.shape, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(parts, (z > 0).to(torch.uint8).cpu())
        masks.append(unblock_nodes(torch.cat(parts).to(dev), pg).bool())
    p64 = {k: v.detach().double().requires_grad_() for k, v in params.items()}
    logits, _ = gcn_dense(p64, xg, s, d, w, n, torch.float64, masks)
    masked_nll(logits, yg, mg, mg.sum().clamp(min=1.0)).backward()
    g64 = {k: v.grad for k, v in p64.items()}
    with torch.no_grad():
        _, z64 = gcn_dense(params, xg, s, d, w, n, torch.float64)
    flips = relu_flips(z_kernel, [blk_z[rows].float() for blk_z in
                                  (block_nodes(z, pg) for z in z64)],
                       f"phase 42 rank {rank} step 0 (float64)")
    step = make_dist_train_step(torch.optim.Adam(params.values(), lr=LR), view)
    losses, step_s, train = [], [], {}
    for i in range(TRAIN_STEPS):
        with torch.no_grad():
            loss64 = float(masked_nll(gcn_dense(params, xg, s, d, w, n, torch.float64)[0],
                                      yg, mg, mg.sum().clamp(min=1.0)))
        ts = time.perf_counter()
        loss, launches = launches_of(lambda: step(params, x, y, m), counters)
        step_s.append(time.perf_counter() - ts)
        expect_launches({k: v for k, v in launches.items() if v}, per_step,
                        f"phase 42 rank {rank} step {i}")
        train = {k: train.get(k, 0) + v for k, v in launches.items() if v}
        lk = float(loss)
        if not abs(lk - loss64) <= LOSS_RTOL * abs(loss64):
            raise AssertionError(f"phase 42 rank {rank} step {i}: loss {lk} vs float64 "
                                 f"{loss64}")
        if i == 0:
            for k, p in params.items():
                gr = g64[k].float()
                torch.testing.assert_close(p.grad, gr, rtol=GRAD_RTOL,
                                           atol=GRAD_RTOL * float(gr.abs().max()))
        losses.append((lk, loss64))
    res["launches"]["train"] = train

    # timings: a request, a step, the exchange alone, one SpMM and the
    # interior reduce alone (the same loops on every rank: they exchange)
    send = x.new_zeros(world * pg.halo, 128)
    recv = torch.empty_like(send)
    xh = torch.randn(pg.nodes_per_part, 128, generator=gen, device=dev)
    with torch.no_grad():
        t_req = cuda_ms(lambda: gcn_forward(params, x, view), iters=5, warmup=1)
        t_spmm = cuda_ms(lambda: halo_spmm(xh, view), iters=5, warmup=1)
        t_int = cuda_ms(lambda: _interior_reduce(view, xh, "auto"), iters=10, warmup=2)
    t_x = cuda_ms(lambda: dist.all_to_all_single(recv, send), iters=10, warmup=2)
    send40, recv40 = send[:, :40].contiguous(), recv[:, :40].contiguous()
    t_x40 = cuda_ms(lambda: dist.all_to_all_single(recv40, send40), iters=10, warmup=2)
    t_step = cuda_ms(lambda: step(params, x, y, m), iters=3, warmup=1)
    res["gcn"] = dict(request_ms=t_req, step_ms=t_step, exchange_ms=t_x, exchange40_ms=t_x40,
                      exchange_share_request=(2 * t_x + t_x40) / t_req,
                      exchange_share_step=2 * (2 * t_x + t_x40) / t_step, spmm_ms=t_spmm,
                      interior_ms=t_int, request_wall_s=req_s, step_wall_s=step_s,
                      losses=losses, request_err=req_err, flips=flips, halo=pg.halo,
                      exchange_mb=send.numel() * 4 / 1e6)

    if rank == 0 and nccl is not None:
        # halo_spmm over a 1-part partition of the arxiv graph in the NCCL
        # group: every edge interior, the exchange of 8 empty slots
        t0 = time.perf_counter()
        pg1 = partition_graph(*job["graphs"]["arxiv"][:2], n, 1,
                              edge_weight=job["graphs"]["arxiv"][2])
        view1 = pg1.part(0, dev)
        build_s = time.perf_counter() - t0
        xb = block_nodes(torch.randn(n, F, generator=gen, device=dev), pg1)
        cb = block_nodes(torch.randn(n, F, generator=gen, device=dev), pg1)

        def run1():
            xx = xb.clone().requires_grad_()
            out = halo_spmm(xx, view1, nccl)
            (out * cb).sum().backward()
            return out.detach(), xx.grad

        (out, grad), launches = launches_of(run1, counters)
        launches = {k: v for k, v in launches.items() if v}
        expect_launches(launches, {"plan_segment_sum_sr": 4},
                        "phase 42 NCCL 1-part forward + x gradient")
        xg_, cg_ = unblock_nodes(xb, pg1), unblock_nodes(cb, pg1)
        blk = lambda t: block_nodes(t, pg1)  # noqa: E731
        err = {"out_vs_f64": check_close_abs_sum(
                   out, blk(spmm64(xg_, s, d, w)).float(),
                   blk(spmm64(xg_.abs(), s, d, w.abs())).float(),
                   "phase 42 NCCL 1-part forward vs float64"),
               "grad_vs_f64": check_close_abs_sum(
                   grad, blk(spmm64(cg_, d, s, w)).float(),
                   blk(spmm64(cg_.abs(), d, s, w.abs())).float(),
                   "phase 42 NCCL 1-part x gradient vs float64")}
        send1 = xb.new_zeros(pg1.halo, 128)
        recv1 = torch.empty_like(send1)
        t_x1 = cuda_ms(lambda: dist.all_to_all_single(recv1, send1, group=nccl), iters=10,
                       warmup=2)
        res["nccl"] = dict(err=err, build_s=build_s, exchange_ms=t_x1,
                           launches=launches, backend=dist.get_backend(nccl))
    return res


def run_parallel(dev, card, graphs, data, c):
    """Phase 42: 2 ranks on cuda:0 in a gloo group (`parallel_rank`), their
    results checked (losses bit-identical across ranks) and logged."""
    from geot_tpu_torch.parallel import spawn_ranks

    arm("par_run")
    job = dict(device=str(dev), n=data.num_nodes, graphs=graphs, x=data.x.astype("float32"),
               y=data.y.astype("int64"), train_mask=data.train_mask, classes=c)
    t0 = time.perf_counter()
    per_rank = spawn_ranks(parallel_rank, 2, job, backend="gloo",
                           timeout=PHASE_BUDGET_S["par_run"] - 30)
    secs = time.perf_counter() - t0
    losses = [[lk for lk, _ in r["gcn"]["losses"]] for r in per_rank]
    if losses[1] != losses[0]:
        raise AssertionError(f"phase 42 losses differ across ranks: {losses}")
    for r in per_rank:
        for layout, h in r["halo"].items():
            log(f"phase 42 rank {r['rank']} halo_spmm {layout}: partition and view "
                f"{h['build_s']:.2f}s, H={h['halo']}, launches (forward + x gradient) "
                f"{h['launches']}, max errors "
                + ", ".join(f"{k} {v:.3e}" for k, v in h["err"].items()))
        gc = r["gcn"]
        log(f"phase 42 rank {r['rank']} GCN ({REQUESTS} requests, {TRAIN_STEPS} Adam steps, "
            f"lr {LR}): launches {r['launches']}; max |request - float64| "
            f"{gc['request_err']:.3e}; losses (kernel, float64) "
            + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in gc["losses"])
            + f"; step-0 ReLU flips vs float64 {gc['flips']}")
        log(f"{card} phase 42 rank {r['rank']} (gloo, host-staged exchange): request "
            f"{gc['request_ms']:.4f} ms, training step {gc['step_ms']:.4f} ms, one "
            f"all_to_all_single of [{2 * gc['halo']}, 128] float32 ({gc['exchange_mb']:.1f} MB) "
            f"{gc['exchange_ms']:.4f} ms (at F 40 {gc['exchange40_ms']:.4f} ms; a request's three "
            f"exchanges {gc['exchange_share_request']:.3f} of it, a step's six "
            f"{gc['exchange_share_step']:.3f}), one halo_spmm at F 128 {gc['spmm_ms']:.4f} ms, its "
            f"interior reduce alone {gc['interior_ms']:.4f} ms; request wall s "
            + ", ".join(f"{t:.4f}" for t in gc["request_wall_s"]) + "; step wall s "
            + ", ".join(f"{t:.4f}" for t in gc["step_wall_s"]))
    nc = per_rank[0]["nccl"]
    log(f"{card} phase 42 NCCL ({nc['backend']}) world size 1, 1-part arxiv partition: "
        f"partition and view {nc['build_s']:.2f}s, launches {nc['launches']}, max errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in nc["err"].items())
        + f"; one all_to_all_single of 8 empty slots {nc['exchange_ms']:.4f} ms")
    log(f"phase 42 done in {secs:.1f}s (2 spawned ranks, losses bit-identical across ranks)")
    faulthandler.cancel_dump_traceback_later()
    return per_rank



CLI_EPOCHS, CLI_DIST_EPOCHS, CLI_ITERS = 200, 20, 100
CLI_WIDTH = ["--hidden", "128", "--num-layers", "3"]


def write_cli_dataset(tmp):
    """Phase 43's data file: `synthetic_classification_graph` at
    ogbn-arxiv's shape (169,343 nodes, 1,166,243 edges, 128 features, 40
    classes; homophilous labels, 60/20/20 splits) in `load_npz`'s format,
    as `tmp`/ogbn-arxiv.npz."""
    import os

    import numpy as np

    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_classification_graph

    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    d = synthetic_classification_graph(n, e, c, feat_dim=f, seed=SEED, name="ogbn-arxiv")
    np.savez(os.path.join(tmp, "ogbn-arxiv.npz"), src=d.src, dst=d.dst, num_nodes=np.int64(n),
             x=d.x, y=d.y, train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask)


def run_cli_train(dev, card, tmp):
    """Phase 43: `geot_tpu_torch.scripts.train` on phase 43's data file,
    in-process: 200 epochs of the GCN (hidden 128, 3 layers) on the kernel
    path and on the reference path (accuracy bars, the two runs agreeing,
    the kernel run's launches, the checkpoint read back into a fresh model
    bit for bit), `--time-only` of every model of MODELS into one CSV, and
    one `python -m` run as a subprocess, started before the training runs
    and waited for before the timings."""
    import ast
    import os

    from geot_tpu_torch.models import MODELS, accuracy, load_checkpoint
    from geot_tpu_torch.scripts import train as cli

    arm("cli_train")
    counters = kernel_counters()
    t0 = time.perf_counter()
    write_cli_dataset(tmp)
    log(f"phase 43 data file ogbn-arxiv.npz written in {time.perf_counter() - t0:.2f}s")
    base = ["--dataset", "ogbn-arxiv", "--data-dir", tmp] + CLI_WIDTH
    res = {"train": {}, "time_only": {}, "launches": {}}
    # `python -m` in a process of its own, started now: its start (importing
    # torch) runs beside the training runs; it is waited for before the
    # timings
    t_sub = time.perf_counter()
    sub = subprocess.Popen([sys.executable, "-m", "geot_tpu_torch.scripts.train", *base,
                            "--model", "gcn", "--time-only", "--iters", "10"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        for backend in ("auto", "reference"):
            ck = os.path.join(tmp, f"gcn_{backend}.npz")
            t0 = time.perf_counter()
            row, launches = launches_of(lambda: cli.main(
                base + ["--model", "gcn", "--epochs", str(CLI_EPOCHS), "--backend", backend,
                        "--checkpoint", ck, "--csv", os.path.join(tmp, "train.csv")]),
                counters)
            launches = {k: v for k, v in launches.items() if v}
            meta = load_checkpoint(ck)[1]
            res["train"][backend] = dict(row=row, seconds=time.perf_counter() - t0, meta=meta)
            res["launches"][f"cli_train_gcn_{backend}"] = launches
            log(f"{card} phase 43 train.py gcn --backend {backend} ({CLI_EPOCHS} epochs): "
                f"{res['train'][backend]['seconds']:.2f}s with the graph's build, row {row}, "
                f"final loss {meta['loss']!r}, launches {launches}")
        # per epoch a step (3 layers forward, 3 over bat_t backward); 21
        # evaluations (every 10th epoch, then the best validation's parameters)
        expect_launches(res["launches"]["cli_train_gcn_auto"],
                        {"bat_segment_sum": CLI_EPOCHS * 6 + 21 * 3},
                        "phase 43 train.py gcn (auto)")
        expect_launches(res["launches"]["cli_train_gcn_reference"], {},
                        "phase 43 train.py gcn (reference)")
        k_meta, r_meta = res["train"]["auto"]["meta"], res["train"]["reference"]["meta"]
        if not (k_meta["train_acc"] > 0.9 and k_meta["val_acc"] > 0.75):
            raise AssertionError(f"phase 43: accuracy below the bar (train > 0.9, "
                                 f"val > 0.75): {k_meta}")
        diffs = {k: abs(k_meta[k] - r_meta[k]) for k in k_meta}
        if any(diffs[k] > 0.01 for k in ("train_acc", "val_acc", "test_acc")):
            raise AssertionError(f"phase 43: accuracies differ from the reference path's by "
                                 f"more than 0.01: {diffs}")
        if not diffs["loss"] <= 1e-2 * abs(r_meta["loss"]):
            raise AssertionError(f"phase 43: final loss {k_meta['loss']} vs the reference "
                                 f"path's {r_meta['loss']}")
        log(f"phase 43 kernel path vs reference path: |differences| {diffs}")
        # the checkpoint read back into a fresh model gives the same accuracies
        data = cli.load_data("ogbn-arxiv", tmp)
        g = cli.build_graph_for("gcn", data, 128, dev)
        state, meta = load_checkpoint(os.path.join(tmp, "gcn_auto.npz"))
        fresh = cli.build_model("gcn", data.x.shape[1], 128, 3, int(data.y.max()) + 1,
                                seed=SEED + 1, device=dev).eval()
        fresh.load_state_dict(state)
        x = torch.from_numpy(data.x).to(dev)
        y = torch.from_numpy(data.y).to(dev).long()
        with torch.no_grad():
            logits = fresh(x, g)
        for split in ("train", "val", "test"):
            mask = torch.from_numpy(getattr(data, f"{split}_mask")).to(dev)
            got = float(accuracy(logits, y, mask))
            if got != meta[f"{split}_acc"]:
                raise AssertionError(f"phase 43 checkpoint read back: {split}_acc {got!r}, "
                                     f"{meta[f'{split}_acc']!r} at the end of training")
        log("phase 43 checkpoint loaded into a fresh GCN: train / val / test accuracies "
            "bit-identical to the trained model's")
        del g, fresh, x, y, logits, data

        out, err = sub.communicate(timeout=PHASE_BUDGET_S["cli_train"])
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.communicate()
    if sub.returncode != 0:
        raise AssertionError(f"phase 43 python -m geot_tpu_torch.scripts.train exited "
                             f"{sub.returncode}:\n{err[-3000:]}")
    row = ast.literal_eval(out.strip().splitlines()[-1])
    if not (row["fwd_ms"] > 0 and row["device"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"phase 43 python -m row: {row}")
    res["subprocess_s"] = time.perf_counter() - t_sub
    log(f"phase 43 python -m geot_tpu_torch.scripts.train --time-only: exit 0, "
        f"{res['subprocess_s']:.2f}s after its start, row {row}")

    times_csv = os.path.join(tmp, "times.csv")
    calls = 10 + CLI_ITERS
    # one forward's launches of each model (3 layers, hidden 128): GCN and
    # GIN a sum a layer, SGC one a propagation (k = 3), APPNP its 10 steps;
    # GraphSAGE's mean adds its degree over the slot plan; GAT takes its
    # edge softmax and sums its heads over the slot plan
    per_forward = {
        "appnp": {"bat_segment_sum": 10},
        "gat": {"plan_segment_sum_mh": 3, "edge_softmax": 3},
        "gcn": {"bat_segment_sum": 3},
        "gin": {"bat_segment_sum": 3},
        "graphsage": {"bat_segment_sum": 3, "plan_segment_sum_pr": 3},
        "sgc": {"bat_segment_sum": 3},
    }
    if sorted(per_forward) != sorted(MODELS):
        raise AssertionError(f"phase 43: expected launches for {sorted(per_forward)}, "
                             f"MODELS holds {sorted(MODELS)}")
    for m in sorted(MODELS):
        row, launches = launches_of(lambda: cli.main(
            base + ["--model", m, "--time-only", "--iters", str(CLI_ITERS), "--csv",
                    times_csv]), counters)
        launches = {k: v for k, v in launches.items() if v}
        expect_launches(launches, {k: v * calls for k, v in per_forward[m].items()},
                        f"phase 43 --time-only {m} ({calls} forward passes)")
        res["launches"][f"cli_time_only_{m}"] = launches
        res["time_only"][m] = dict(fwd_ms=row["fwd_ms"],
                                   per_forward={k: v // calls for k, v in launches.items()})
        log(f"{card} phase 43 train.py --time-only {m} (hidden 128, 3 layers): fwd_ms "
            f"{row['fwd_ms']!r}, launches per forward {res['time_only'][m]['per_forward']}")
    with open(times_csv) as f:
        lines = f.read().splitlines()
    if len(lines) != 1 + len(MODELS) or lines[0] != ",".join(row):
        raise AssertionError(f"phase 43 --csv: {lines[:2]}... ({len(lines)} lines)")
    faulthandler.cancel_dump_traceback_later()
    return res


def run_cli_dist(card, tmp):
    """Phase 44: `geot_tpu_torch.scripts.train_dist` on phase 43's data
    file (hidden 128, 3 layers, 20 epochs), in-process: 2 gloo ranks
    sharing cuda:0 and 1 NCCL rank; the two runs' losses and accuracies
    agreeing, the loss falling, and each rank's launches per step and
    evaluation those of phase 42's GCN."""
    import math

    from geot_tpu_torch.scripts import train_dist as cli_dist

    arm("cli_dist")
    base = ["--dataset", "ogbn-arxiv", "--data-dir", tmp, "--epochs", str(CLI_DIST_EPOCHS)]
    per_request = {"plan_segment_sum_sr": 4, "plan_segment_sum_sr_packed": 2}
    runs = {}
    for label, extra in (("gloo2", ["--parts", "2", "--dist-backend", "gloo"]),
                         ("nccl1", ["--parts", "1", "--dist-backend", "nccl"])):
        t0 = time.perf_counter()
        out = cli_dist.main(base + CLI_WIDTH + extra)
        out["seconds"] = time.perf_counter() - t0
        runs[label] = out
        if out["layout"] != "slot":
            raise AssertionError(f"phase 44 {label}: layout {out['layout']}, expected slot")
        for r, launches in enumerate(out["launches"]):
            expect_launches(launches["train"],
                            {k: 2 * v * CLI_DIST_EPOCHS for k, v in per_request.items()},
                            f"phase 44 {label} rank {r} training ({CLI_DIST_EPOCHS} steps)")
            expect_launches(launches["eval"], per_request, f"phase 44 {label} rank {r} eval")
        log(f"{card} phase 44 train_dist.py {label}: {out['seconds']:.2f}s in all, partition "
            f"{out['partition_s']:.2f}s, H={out['halo']}, nodes/part {out['nodes_per_part']}, "
            f"mean epoch time {out['epoch_ms']!r} ms (the first {out['first_epoch_ms']!r} ms), "
            f"losses {out['losses']}, accuracies "
            + ", ".join(f"{k} {out[k]!r}" for k in ("train_acc", "val_acc", "test_acc"))
            + f", launches per rank {out['launches']}")
    a, b = runs["gloo2"], runs["nccl1"]
    for epoch in (10, 20):
        if not abs(a["losses"][epoch] - b["losses"][epoch]) <= 1e-3 * abs(b["losses"][epoch]):
            raise AssertionError(f"phase 44 epoch {epoch}: loss {a['losses'][epoch]} (2 parts) "
                                 f"vs {b['losses'][epoch]} (1 part)")
    for k in ("train_acc", "val_acc", "test_acc"):
        if abs(a[k] - b[k]) > 0.01:
            raise AssertionError(f"phase 44 {k}: {a[k]} (2 parts) vs {b[k]} (1 part)")
    for label, out in runs.items():
        if not out["losses"][20] < min(out["losses"][10], math.log(40)):
            raise AssertionError(f"phase 44 {label}: losses {out['losses']} do not fall "
                                 f"below ln 40")
    log(f"phase 44 2 gloo parts vs 1 NCCL part: losses {a['losses']} vs {b['losses']}")
    faulthandler.cancel_dump_traceback_later()
    return runs


def softmax_graph(dev):
    """The arxiv-gat benchmark cell's graph over slot plans: ogbn-arxiv's
    nodes and edges from `synthetic_graph` (Zipf(1.0), seed 0, the edges as
    the benchmark's frozen copy draws them), each edge and its reverse,
    duplicates dropped, then self-loops."""
    import numpy as np

    from geot_tpu_torch.graph.datasets import synthetic_graph
    from geot_tpu_torch.models import prepare_graph

    n = 169_343
    data = synthetic_graph(n, 1_166_243, seed=0)
    s = np.concatenate([data.src, data.dst]).astype(np.int64)
    d = np.concatenate([data.dst, data.src]).astype(np.int64)
    key = np.unique(d * n + s)
    return prepare_graph((key % n).astype(np.int32), (key // n).astype(np.int32), n,
                         add_self_loops=True, layouts=("slot",), device=dev)


def run_softmax(dev, card):
    """Phase 45: the edge softmax against its plain version, then its
    times beside the plain version's and the bound (module docstring)."""
    import numpy as np

    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops.softmax_kernels import (
        edge_softmax,
        edge_softmax_grad,
        edge_softmax_grad_plain,
        edge_softmax_plain,
    )
    from geot_tpu_torch.profile_gcn import trace

    arm("softmax")
    res = {"checks": {}}
    t0 = time.perf_counter()
    big = softmax_graph(dev)
    deg = torch.diff(big.dst_ptr)
    log(f"phase 45 graph: {big.num_nodes} nodes, {big.num_edges} edges, max in-degree "
        f"{int(deg.max())}, {int((deg > 1024).sum())} rows over 1,024 edges holding "
        f"{int(deg[deg > 1024].sum())}, median {int(deg.float().median())}; "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(45)
    n_s = 3000
    dst_s = np.concatenate([np.full(4000, 5, np.int32),
                            rng.integers(0, n_s - 200, 20000).astype(np.int32)])
    src_s = rng.integers(0, n_s, len(dst_s)).astype(np.int32)
    small = prepare_graph(src_s, dst_s, n_s, add_self_loops=False, layouts=("slot",),
                          e_tile=512, s_tile=256, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)

    def rel_elem(k, p):
        return float(((k.double() - p).abs() / p.abs().clamp(min=1e-30)).max())

    def rel_norm(k, p):
        return float((k.double() - p).abs().max() / p.abs().max().clamp(min=1e-30))

    def abs_err(k, p):
        return float((k.double() - p).abs().max())

    def check(label, g, H, node):
        E, n = g.num_edges, g.num_nodes
        a_s = 0.5 * torch.randn(n, H, generator=gen, device=dev)
        a_d = 0.5 * torch.randn(n, H, generator=gen, device=dev)
        a_s[int(g.src[0])] = -a_d[int(g.dst[0])]  # a pre-activation exactly 0
        lg = 0.7 * torch.randn(E, H, generator=gen, device=dev)
        gg = torch.randn(E, H, generator=gen, device=dev)
        idx = (g.dst, g.dst_ptr)
        kw = (dict(alpha_src=a_s, alpha_dst=a_d, src=g.src) if node else {})
        kw64 = (dict(alpha_src=a_s.double(), alpha_dst=a_d.double(), src=g.src)
                if node else {})
        logits = None if node else lg
        bk = edge_softmax.launches
        att = edge_softmax(*idx, logits, **kw)
        torch.cuda.synchronize()
        expect_launches(edge_softmax.launches - bk, 1, f"{label} forward")
        p64 = edge_softmax_plain(*idx, None if node else lg.double(), **kw64)
        e_f, e_abs = rel_elem(att, p64), abs_err(att, p64)
        e_32 = rel_elem(att, edge_softmax_plain(*idx, logits, **kw).double())
        rows = torch.zeros(n, H, dtype=torch.float64, device=dev).index_add_(
            0, g.dst.long(), att.double())
        nonempty = torch.diff(g.dst_ptr) > 0
        e_sum = float((rows[nonempty] - 1).abs().max())
        runs = dict(perm_t=g.perm_t, src_t=g.src.index_select(0, g.perm_t.long()),
                    src_ptr=g.src_ptr)
        tkw = dict(kw, **runs) if node else {}
        tkw64 = dict(kw64, **runs) if node else {}
        bg = edge_softmax_grad.launches
        grads = edge_softmax_grad(*idx, att, gg, **tkw)
        torch.cuda.synchronize()
        expect_launches(edge_softmax_grad.launches - bg, 1, f"{label} backward")
        grads32 = edge_softmax_grad_plain(*idx, att, gg, **tkw)
        grads64 = edge_softmax_grad_plain(*idx, att.double(), gg.double(), **tkw64)
        grads, grads32, grads64 = ((x if node else (x,)) for x in (grads, grads32, grads64))
        e_g = max(rel_norm(k, p) for k, p in zip(grads, grads64))
        e_abs = max([e_abs] + [abs_err(k, p) for k, p in zip(grads, grads64)])
        e_g32 = max(rel_norm(k, p.double()) for k, p in zip(grads, grads32))
        for _ in range(2):
            again = edge_softmax(*idx, logits, **kw)
            g2 = edge_softmax_grad(*idx, again, gg, **tkw)
            g2 = g2 if node else (g2,)
            if not torch.equal(again, att) or not all(torch.equal(a, b)
                                                      for a, b in zip(g2, grads)):
                raise AssertionError(f"{label}: reruns are not bit-identical")
        log(f"phase 45 {label}: att rel err {e_f:.3e} (the plain version in float32 "
            f"{e_32:.3e}; rows sum to 1 within {e_sum:.1e}), gradients {e_g:.3e} of their "
            f"largest (float32: {e_g32:.3e})")
        if not (e_f <= 1e-6 and e_g <= 1e-5 and e_sum <= 1e-5):
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        res["checks"][label] = {"att_rel": e_f, "grad_rel": e_g, "row_sum": e_sum, "abs": e_abs,
                                "att_rel_plain_f32": e_32, "grad_rel_plain_f32": e_g32}

    for label, g, H in (("cell_H3", big, 3), ("small_H1", small, 1), ("small_H3", small, 3),
                        ("small_H8", small, 8)):
        check(f"{label}_node_terms", g, H, True)
        check(f"{label}_logits", g, H, False)

    # times at the cell's shapes: 3 heads, the forward alone and the
    # backward alone (both gradients), beside the plain versions
    g, H = big, 3
    a_s = torch.randn(g.num_nodes, H, generator=gen, device=dev)
    a_d = torch.randn(g.num_nodes, H, generator=gen, device=dev)
    gg = torch.randn(g.num_edges, H, generator=gen, device=dev)
    kw = dict(alpha_src=a_s, alpha_dst=a_d, src=g.src)
    att = edge_softmax(g.dst, g.dst_ptr, **kw)
    tkw = dict(kw, perm_t=g.perm_t, src_t=g.src.index_select(0, g.perm_t.long()),
               src_ptr=g.src_ptr)
    fwd = lambda: edge_softmax(g.dst, g.dst_ptr, **kw)  # noqa: E731
    bwd = lambda: edge_softmax_grad(g.dst, g.dst_ptr, att, gg, **tkw)  # noqa: E731

    def device_ms(fn, iters=20):
        _, _, busy, events = trace(fn, iters, warmup=3)
        by = {}
        for ev in events:
            k = ev.name.replace("(anonymous namespace)::", "").replace("void ", "")
            k = k.split("(")[0].split("<")[0].split("::")[-1][:60]
            by[k] = by.get(k, 0.0) + ev.time_range.elapsed_us() / 1e3 / iters
        return busy / 1e3 / iters, dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def sm_clock():
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()

    t = {"rounds": []}
    for r in range(3):
        row = {"sm_clock": sm_clock()}
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            busy, by = device_ms(fn)
            row[name] = {"device_ms": busy, "events_ms": cuda_ms(fn, iters=50),
                         "kernels_ms": {k: round(v, 5) for k, v in by.items()}}
            log(f"phase 45 round {r} time {name} (SM clock {row['sm_clock']}): device "
                f"{busy:.4f} ms a call, back to back {row[name]['events_ms']:.4f} ms; {by}")
        t["rounds"].append(row)
    for name in ("fwd", "bwd"):  # the median round, and the rounds' range
        ms = sorted(row[name]["device_ms"] for row in t["rounds"])
        t[f"{name}_ms"], t[f"{name}_range_ms"] = ms[1], (ms[0], ms[-1])
    t["plain_fwd_ms"] = cuda_ms(lambda: edge_softmax_plain(g.dst, g.dst_ptr, **kw))
    t["plain_bwd_ms"] = cuda_ms(lambda: edge_softmax_grad_plain(g.dst, g.dst_ptr, att, gg, **tkw))
    E, n = g.num_edges, g.num_nodes
    # least bytes: forward reads src, dst_ptr and both node terms and
    # writes att; backward reads the same, att and g, and perm_t and
    # src_ptr for the src-sorted sum, and writes both gradients (the
    # logits' gradient stays on chip in the least)
    fwd_bytes = E * 4 + (n + 1) * 4 + 2 * n * H * 4 + E * H * 4
    bwd_bytes = E * 8 + 2 * (n + 1) * 4 + 2 * n * H * 4 + 2 * E * H * 4 + 2 * n * H * 4
    t["bound_fwd_ms"], _ = bound_ms(fwd_bytes, 0)
    t["bound_bwd_ms"], _ = bound_ms(bwd_bytes, 0)
    log(f"phase 45 {card}: forward {t['fwd_ms']:.4f} ms (bound {t['bound_fwd_ms']:.4f} ms, "
        f"{fwd_bytes} B; plain {t['plain_fwd_ms']:.4f} ms), backward {t['bwd_ms']:.4f} ms "
        f"(bound {t['bound_bwd_ms']:.4f} ms, {bwd_bytes} B; plain {t['plain_bwd_ms']:.4f} ms)")
    res["timing"] = t
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr, flush=True)
        return 2
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import build_bat_plan, compute_chunks, with_chunks
    from geot_tpu_torch.models import (
        GCN,
        gcn_edge_weight,
        make_optimizer,
        make_train_step,
        prepare_graph,
    )
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops import reference as ref_ops
    from geot_tpu_torch.ops._build import build_kernels
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain
    from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat, sddmm_bat_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the default; stated
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi, flush=True)
    log(f"phase 1 card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    arm("build")
    tb = time.perf_counter()
    reports = build_kernels(verbose=False)
    log(f"phase 2 build: {time.perf_counter() - tb:.2f}s"
        + ("" if reports else " (already built in this checkout)"))
    for name, (secs, rep) in reports.items():
        log(f"  {name}: nvcc {secs:.2f}s")
        for line in rep.splitlines():  # per kernel: registers, smem, spills
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("    " + line.strip())
    # graph + model (host build is set-up, outside the phases' checks)
    arm("serve")
    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=SEED)
    g = prepare_graph(data.src, data.dst, n, layouts=("bat",), device=dev)
    bp, bpt = g.bat, g.bat_t
    n_chunks = max(len(bp.chunks), 1)
    n_chunks_t = max(len(bpt.chunks), 1)
    deg = torch.bincount(g.dst.long(), minlength=n)
    log(f"graph: {n} nodes, {g.num_edges} edges (self-loops added), plan "
        f"{bp.num_tiles} tiles e_tile={bp.e_tile} s_tile={bp.s_tile} "
        f"{bp.n_blocks} windows, chunks={n_chunks}; transpose plan {bpt.num_tiles} "
        f"tiles, chunks={n_chunks_t}; head window "
        f"{int(deg[:bp.s_tile].sum())} edges, max in-degree {int(deg.max())}")
    x = torch.from_numpy(data.x).to(dev)
    nnz = g.num_edges

    # 3. bat_segment_sum vs plain at the real plans, both forms (edge-order
    # values; x[src[e]] read in the kernel), at the layers' widths 128 and
    # 40 and at 100 and 47 (not multiples of 128, 47 not of 4)
    arm("kernel")
    w_gcn = gcn_edge_weight(g)
    w_t = w_gcn[g.perm_t.long()]
    kgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    max_err, n_checks = 0.0, 0

    def held_bat(plan, xv, w, src, what):
        """bat_segment_sum against its plain version, and rerun bit-identical."""
        nonlocal max_err, n_checks
        k = bat_segment_sum(plan, xv, w, src=src)
        torch.cuda.synchronize()
        p = bat_segment_sum_plain(plan, xv, w, src=src)
        a = bat_segment_sum_plain(plan, xv.abs(), None if w is None else w.abs(), src=src)
        max_err = max(max_err, check_close_abs_sum(k, p, a, what))
        if not torch.equal(bat_segment_sum(plan, xv, w, src=src), k):
            raise AssertionError(f"{what}: not deterministic")
        n_checks += 1
        return k

    for F in (128, 100, 47, c):
        xf = torch.randn(n, F, generator=kgen, device=dev)
        for d, plan, src_d, w_d in (("bat", bp, g.src, w_gcn), ("bat_t", bpt, g.dst_t, w_t)):
            vals_d = xf.index_select(0, src_d.long())  # [nnz, F], edge order
            for label, w in (("weighted", w_d), ("unweighted", None)):
                held_bat(plan, xf, w, src_d, f"phase 3 {d} F={F} {label} gathered")
                held_bat(plan, vals_d, w, None, f"phase 3 {d} F={F} {label} values")
            del vals_d
        del xf
    # a plan forced into ragged chunks that split the hub window, and a
    # uniformized chunked plan whose pad tiles point at the sentinel block
    # and past the next chunk's first window: each summed whole, one launch
    hub_w = int(torch.bincount(bp.out_block.long()).argmax())
    cap = max(int(torch.bincount(bp.out_block.long()).max()) // 3, 2)
    ch = compute_chunks(bp.out_block.cpu().numpy(), cap)
    split = [(a[3], b[2]) for a, b in zip(ch[:-1], ch[1:]) if b[2] < a[3]]
    if len(ch) < 3 or not split:
        raise AssertionError("forced chunking did not split a hub window")
    bpc = with_chunks(bp, ch)
    dst_np = g.dst.cpu().numpy()
    for cap_u in (700, 600, 500, 400, 300, 200):
        bpu = build_bat_plan(dst_np, n, e_tile=bp.e_tile, s_tile=bp.s_tile,
                             max_chunk_tiles=cap_u, device=dev)
        ob_u = bpu.out_block.cpu()
        if bpu.chunks and bool((ob_u[1:] < ob_u[:-1]).any()):
            break
    else:
        raise AssertionError("no chunk cap puts a pad tile past the next chunk's window")
    with torch.inference_mode():
        whole = bat_segment_sum(bp, x, w_gcn, src=g.src)
        for lbl, plan in ((f"{len(ch)} ragged chunks, hub window {hub_w} split", bpc),
                          (f"{len(bpu.chunks)} uniform chunks of cap {cap_u}, pad tiles "
                           "past the next chunk", bpu)):
            before = bat_segment_sum.launches
            got = api._spmm_fwd_bat(plan, x, g.src, w_gcn)
            torch.cuda.synchronize()
            expect_launches(bat_segment_sum.launches - before, 1,
                            f"phase 3 chunked route ({lbl}): one launch a plan")
            held_bat(plan, x, w_gcn, g.src, f"phase 3 chunked ({lbl})")
            if not torch.equal(got, whole[:n]):
                raise AssertionError(f"phase 3 chunked ({lbl}): differs from the whole plan")
    log(f"phase 3 {n_checks} bat_segment_sum checks within the abs-sum rule, reruns "
        "bit-identical; both chunked plans (one launch each) bit-identical to the whole plan")
    del whole, got, bpu

    # 4. serve: GCN inference requests
    arm("serve")
    gen = torch.Generator().manual_seed(SEED)
    model = GCN(f, 128, 3, c, generator=gen, device=dev).eval()
    ref_model = GCN(f, 128, 3, c, backend="reference", device=dev).eval()
    ref_model.load_state_dict(model.state_dict())
    outs, req_s = [], []
    bat_segment_sum.launches = 0  # count the serving path's launches only
    sddmm_bat.launches = 0
    with torch.inference_mode():
        for i in range(REQUESTS):
            before = bat_segment_sum.launches
            ts = time.perf_counter()
            out = model(x, g)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - ts)
            if bat_segment_sum.launches - before != 3:
                raise AssertionError(
                    f"request {i}: {bat_segment_sum.launches - before} kernel launches, "
                    "expected 3 (one a layer, the plan whole)")
            outs.append(out)
    serve_launches = bat_segment_sum.launches
    serve_sddmm = sddmm_bat.launches
    if serve_sddmm:
        raise AssertionError("serving launched sddmm_bat")
    log(f"phase 4 serve: {REQUESTS} requests, bat_segment_sum launches={serve_launches} "
        f"(3 layers, one launch a plan of {n_chunks} chunk(s)); request s: "
        + ", ".join(f"{s:.4f}" for s in req_s))
    with torch.inference_mode():
        ref = ref_model(x, g)
    for i, out in enumerate(outs):
        if out.shape != (n, c) or not torch.isfinite(out).all():
            raise AssertionError(f"request {i}: bad output {tuple(out.shape)}")
        torch.testing.assert_close(out, ref, **MODEL_TOL)
    log(f"phase 4 check: outputs [{n}, {c}] finite, max |kernel path - reference path| "
        f"= {float((outs[0] - ref).abs().max()):.3e} (tolerance {MODEL_TOL})")
    del outs, ref

    # 5. timing of the serving path: bat_segment_sum in both forms (the
    # routes run the gathered one), the [E, F] gather alone, the plain
    # version, the library yardsticks (torch.sparse.mm, never called by the
    # port: the node CSR for the gathered form, the edge -> row CSR for the
    # values form), one SpMM and one forward pass
    arm("timing")
    t5 = bat_timing(bp, x, g.src, g.dst, w_gcn, card, "bat (arxiv GCN)")
    t5_40 = bat_timing(bp, torch.randn(n, c, generator=kgen, device=dev), g.src, g.dst,
                       w_gcn, card, "bat (arxiv GCN, layer 3)", plain=False)
    t_k, t_p, bound, bound_by, t_lib = (t5["ms"], t5["plain_ms"], t5["bound_ms"],
                                        t5["bound_by"], t5["library_ms"])
    with torch.inference_mode():
        t_spmm = cuda_ms(lambda: api.segment_spmm(g, x, edge_weight=w_gcn))
        t_fwd = cuda_ms(lambda: model(x, g), iters=5)
    log(f"{card} segment_spmm (one layer's SpMM, x[src[e]] read in the kernel) "
        f"{t_spmm:.4f} ms")
    log(f"{card} GCN forward (3 layers) {t_fwd:.4f} ms; request wall "
        f"{min(req_s) * 1e3:.4f} ms min")

    # 6. sddmm_bat vs plain at the real plan and at a chunked plan, both
    # forms: b in edge order (the TPU kernel's contract) and b[src[e]]
    # read in the kernel (what the routes run)
    arm("sddmm")
    F = x.shape[1]
    sgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    a_nodes = torch.randn(n, F, generator=sgen, device=dev)
    b_nodes = torch.randn(n, F, generator=sgen, device=dev)
    b_vals = b_nodes.index_select(0, g.src.long())  # [nnz, F], edge order
    sddmm_err = 0.0

    def held_sddmm(plan, what):
        """Both forms of sddmm_bat over `plan` against the plain version,
        reruns bit-identical; returns the gathered dots."""
        nonlocal sddmm_err
        out = None
        for form, b_, kw in (("values", b_vals, {}), ("gathered", b_nodes, {"src": g.src})):
            k = sddmm_bat(plan, a_nodes, b_, **kw)
            torch.cuda.synchronize()
            p = sddmm_bat_plain(plan, a_nodes, b_, **kw)
            a = sddmm_bat_plain(plan, a_nodes.abs(), b_.abs(), **kw)
            sddmm_err = max(sddmm_err, check_close_abs_sum(k, p, a,
                                                           f"phase 6 sddmm_bat {form} {what}"))
            if not torch.equal(sddmm_bat(plan, a_nodes, b_, **kw), k):
                raise AssertionError(f"phase 6 sddmm_bat {form} {what}: not deterministic")
            if out is not None and not torch.equal(k, out):
                raise AssertionError(f"phase 6 sddmm_bat {what}: the forms differ")
            out = k
        return out

    ks = held_sddmm(bp, "(the real plan)")
    for cap_c in (700, 600, 500, 400, 300, 200):
        bpu = build_bat_plan(dst_np, n, e_tile=bp.e_tile, s_tile=bp.s_tile,
                             max_chunk_tiles=cap_c, device=dev)
        if bpu.chunks and int(bpu.out_block.max()) >= bpu.n_blocks:
            break
    else:
        raise AssertionError("no chunk cap puts a pad tile past n_blocks")
    ku = held_sddmm(bpu, f"chunked ({len(bpu.chunks)} uniform chunks of cap {cap_c}, pad "
                         f"tiles up to window {int(bpu.out_block.max())} of {bpu.n_blocks})")
    # each edge's dot is its tile's: equal to the unchunked dots
    if not torch.equal(ku[:nnz], ks[:nnz]):
        raise AssertionError("sddmm_bat differs between the plain and chunked plan")
    log("phase 6 both forms bit-identical to each other and across reruns; the chunked plan "
        f"equals the unchunked one on all {nnz} edges")
    del ku, bpu

    # 7. the weight gradient through gather_weight_scatter
    arm("grad")
    cot = torch.randn(n, F, generator=sgen, device=dev)
    w_dyn = w_gcn * (1.0 + 0.1 * torch.randn(nnz, generator=sgen, device=dev))

    def gws_grads(backend):
        xx = x.clone().requires_grad_()
        ww = w_dyn.clone().requires_grad_()
        out = api.gather_weight_scatter(g.src, g.dst, ww, xx, n, graph=g, backend=backend)
        torch.vdot(out.reshape(-1), cot.reshape(-1)).backward()
        return xx.grad, ww.grad

    bat_segment_sum.launches = 0  # count the gradient path's launches only
    sddmm_bat.launches = 0
    dx, dw = gws_grads("auto")
    torch.cuda.synchronize()
    grad_launches = {"bat_segment_sum": bat_segment_sum.launches,
                     "sddmm_bat": sddmm_bat.launches}
    if grad_launches != {"bat_segment_sum": 2, "sddmm_bat": 1}:
        raise AssertionError(f"gradient path launches {grad_launches}, expected "
                             "1 + 1 bat_segment_sum (bat, bat_t) and 1 sddmm_bat")
    dx_r, dw_r = gws_grads("reference")
    dx_abs = ref_ops.gather_weight_scatter_ref(g.dst, g.src, w_dyn.abs(), cot.abs(), n)
    dw_abs = ref_ops.sddmm_coo_ref(g.src, g.dst, cot.abs(), x.abs())
    check_close_abs_sum(dx, dx_r, dx_abs, "phase 7 dx (transpose plan) vs reference")
    grad_err = check_close_abs_sum(dw, dw_r, dw_abs, "phase 7 dw (sddmm_bat) vs reference")
    # sddmm_coo with a graph: one sddmm_bat launch, a[dst[e]] and b[src[e]]
    # read in the kernel
    sddmm_bat.launches = 0
    with torch.inference_mode():
        coo = api.sddmm_coo(g.src, g.dst, a_nodes, b_nodes, graph=g)
    torch.cuda.synchronize()
    expect_launches(sddmm_bat.launches, 1, "phase 7 sddmm_coo(graph=)")
    grad_err = max(grad_err, check_close_abs_sum(
        coo, ref_ops.sddmm_coo_ref(g.src, g.dst, a_nodes, b_nodes),
        ref_ops.sddmm_coo_ref(g.src, g.dst, a_nodes.abs(), b_nodes.abs()),
        "phase 7 sddmm_coo(graph=) vs sddmm_coo_ref"))
    log("phase 7 launches: forward 1 + backward 1 bat_segment_sum (each plan whole), "
        "1 sddmm_bat (b[src[e]] read in the kernel: no edge-order gather); sddmm_coo(graph=) "
        "1 sddmm_bat")
    del dx, dw, dx_r, dw_r, dx_abs, dw_abs, coo

    # 8. training: 5 AdamW steps, kernel path beside the reference path
    arm("train")
    ref_model.load_state_dict(model.state_dict())
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    step = make_train_step(model, make_optimizer(model, LR, WEIGHT_DECAY), has_dropout=False)
    ref_step = make_train_step(ref_model, make_optimizer(ref_model, LR, WEIGHT_DECAY),
                               has_dropout=False)
    per_step = 3 + 3
    losses, step_s = [], []
    bat_segment_sum.launches = 0  # count the training path's launches only
    sddmm_bat.launches = 0
    for i in range(TRAIN_STEPS):
        before = bat_segment_sum.launches
        ts = time.perf_counter()
        loss = step(x, g, y, mask)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts)
        if bat_segment_sum.launches - before != per_step:
            raise AssertionError(f"step {i}: {bat_segment_sum.launches - before} "
                                 f"bat_segment_sum launches, expected {per_step}")
        loss_r = ref_step(x, g, y, mask)
        if i == 0:
            pr = dict(ref_model.named_parameters())
            for name, prm in model.named_parameters():
                gr = pr[name].grad
                torch.testing.assert_close(prm.grad, gr, rtol=GRAD_RTOL,
                                           atol=GRAD_RTOL * float(gr.abs().max()))
            log(f"phase 8 step 0 gradients agree per tensor "
                f"(rtol {GRAD_RTOL}, atol {GRAD_RTOL} * max|g_ref|)")
        lk, lr_ = float(loss), float(loss_r)
        if not (abs(lk - lr_) <= LOSS_RTOL * abs(lr_)) or lk != lk:
            raise AssertionError(f"step {i}: loss {lk} vs reference {lr_}")
        losses.append((lk, lr_))
    train_launches = bat_segment_sum.launches
    train_sddmm = sddmm_bat.launches
    if train_sddmm:
        raise AssertionError("GCN training launched sddmm_bat")
    log(f"phase 8 train: {TRAIN_STEPS} steps, losses (kernel, reference) "
        + ", ".join(f"({a:.6f}, {b:.6f})" for a, b in losses))
    log(f"phase 8 launches: bat_segment_sum {train_launches} = {TRAIN_STEPS} x "
        f"(3 forward + 3 backward, one a plan); sddmm_bat {train_sddmm} "
        "(gcn_edge_weight is a constant of the graph: no dw is asked for)")
    log("phase 8 step wall s: " + ", ".join(f"{s:.4f}" for s in step_s))

    # 9. timing of the training path
    arm("timing_train")
    t_step = cuda_ms(lambda: step(x, g, y, mask), iters=5, warmup=1)
    t_bwd = cuda_ms(lambda: api._spmm_fwd_bat(bpt, cot, g.dst_t, w_t))
    t9 = bat_timing(bpt, cot, g.dst_t, g.src.index_select(0, g.perm_t.long()), w_t, card,
                    "bat_t (arxiv GCN backward)", plain=False)
    t_kt, bound_t = t9["ms"], t9["bound_ms"]
    # sddmm_bat: the gathered form (the routes'), the values form (the TPU
    # contract), and the old route's work before its kernel: a padded to
    # the windows and b gathered into whole value blocks
    t_sk = cuda_ms(lambda: sddmm_bat(bp, a_nodes, b_nodes, src=g.src))
    t_sp = cuda_ms(lambda: sddmm_bat_plain(bp, a_nodes, b_nodes, src=g.src), iters=5)
    t_sv = cuda_ms(lambda: sddmm_bat(bp, a_nodes, b_vals))
    src_pad = torch.nn.functional.pad(g.src.long(), (0, bp.n_vblocks * bp.e_tile - nnz))
    rows_pad = (bp.n_blocks + (bp.chunk_blocks if bp.chunks else 0)) * bp.s_tile
    t_old_gather = cuda_ms(lambda: (
        torch.nn.functional.pad(a_nodes, (0, 0, 0, rows_pad - n)).contiguous(),
        b_nodes.index_select(0, src_pad)))
    n_dst = int(torch.unique(g.dst).numel())
    # gathered: a's and b's rows once each, dst and src, out; values: the
    # [nnz, F] b block, the a rows of every dst node, dst3 and out
    s_bytes = 2 * n * F * 4 + 2 * nnz * 4 + (bp.n_vblocks + 1) * bp.e_tile * 4
    s_bound, s_bound_by = bound_ms(s_bytes, 2 * nnz * F)
    s_rows_bytes = nnz * F * 4 + n_dst * F * 4 + 2 * nnz * 4 + (bp.n_vblocks + 1) * bp.e_tile * 4
    s_rows_bound, _ = bound_ms(s_rows_bytes, 2 * nnz * F)
    sv_bytes = nnz * F * 4 + n_dst * F * 4 + 2 * (bp.n_vblocks + 1) * bp.e_tile * 4
    sv_bound, sv_bound_by = bound_ms(sv_bytes, 2 * nnz * F)
    pattern = torch.sparse_coo_tensor(
        torch.stack([g.dst.long(), g.src.long()]), torch.ones(nnz, device=dev), (n, n),
        check_invariants=False).coalesce()
    merged = nnz - pattern._nnz()
    pattern = pattern.to_sparse_csr()
    b_t = b_nodes.t().contiguous()
    t_slib = cuda_ms(lambda: torch.sparse.sampled_addmm(pattern, a_nodes, b_t,
                                                        beta=0.0, alpha=1.0))
    log(f"{card} training step (3-layer GCN, forward + backward + AdamW) {t_step:.4f} ms; "
        f"step wall {min(step_s) * 1e3:.4f} ms min")
    log(f"{card} backward SpMM over bat_t (one layer, x[src[e]] read in the kernel) "
        f"{t_bwd:.4f} ms")
    log(f"{card} sddmm_bat gathered (a[dst[e]] and b[src[e]] read in the kernel) {t_sk:.4f} ms "
        f"(bound {s_bound:.4f} ms by {s_bound_by}: {s_bytes / 1e9:.3f} GB, a's and b's rows "
        f"once; {s_rows_bound:.4f} ms with each edge's b row once: {s_rows_bytes / 1e9:.3f} GB) "
        f"|| values form (b in edge order) {t_sv:.4f} ms (bound {sv_bound:.4f} ms by "
        f"{sv_bound_by}: {sv_bytes / 1e9:.3f} GB: b_vals, {n_dst} a rows, dst3, out); the old "
        f"route's a padding and [E, F] b gather before its kernel {t_old_gather:.4f} ms")
    log(f"{card} sddmm_bat_plain (gathered) {t_sp:.4f} ms")
    log(f"{card} library torch.sparse.sampled_addmm (CSR pattern of the graph) "
        f"{t_slib:.4f} ms; the CSR pattern merges {merged} duplicate edges "
        f"({pattern._nnz()} of {nnz} positions)")
    faulthandler.cancel_dump_traceback_later()
    del pattern, b_t, a_nodes, b_nodes, b_vals, cot

    hy = run_hybrid(dev, card)
    sl = run_slot(dev, card)
    gd = run_gat_dyn(dev, card)
    nr = run_narrow(dev, card)
    bk = run_bucketed(dev, card, data)
    nat = run_native(dev, data)
    tu = run_tuning(dev, card, data, bk.pop("graph"))
    co = run_compiler(dev, card, g, x)
    c19 = check_c19(bk.pop("c19"))
    pgs, pgraphs, p40 = run_partition(g, w_gcn, n, e)
    p41, p41_view_s = run_part_reduces(dev, pgs)
    del pgs
    p42 = run_parallel(dev, card, pgraphs, data, c)
    cli_tmp = tempfile.mkdtemp(prefix="geot_cli_")
    try:
        p43 = run_cli_train(dev, card, cli_tmp)
        p44 = run_cli_dist(card, cli_tmp)
    finally:
        shutil.rmtree(cli_tmp, ignore_errors=True)
    sm = run_softmax(dev, card)

    def hyb_entry(name, key, source_line):
        return {
            "name": name,
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/stream_segment.cu",
            "replaces": f"geot_tpu/ops/pallas_segment.py:{source_line}",
            "launches": hy["train"][name],
            "launches_by_path": {"hybrid_serve_requests": hy["serve"][name],
                                 "hybrid_train_steps": hy["train"][name],
                                 "hybrid_train_per_step": hy["train"][name] // TRAIN_STEPS},
            "max_abs_err": hy["errs"][name],
            **hy[key],
        }

    def slot_entry(name, source_line, F, source="slot_segment_sum.cu"):
        by_path = {}
        for m in ("graphsage", "gcn"):
            by_path[f"{m}_serve_requests"] = sl["serve"][m][name]
            by_path[f"{m}_train_steps"] = sl["train"][m][name]
        return {
            "name": name,
            "route": "cuda",
            "source": f"geot_tpu_torch/ops/csrc/{source}",
            "replaces": f"geot_tpu/ops/pallas_segment.py:{source_line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": sl["errs"][name],
            "F": F,
            **sl["timing"][(name, F)],
        }

    def new_entry(name, source, source_line, F):
        by_path = {}
        for m in ("gat", "gcn_dyn64", "gcn_dyn128"):
            by_path[f"{m}_serve_requests"] = gd["serve"][m][name]
            by_path[f"{m}_train_steps"] = gd["train"][m][name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"geot_tpu_torch/ops/csrc/{source}",
            "replaces": f"geot_tpu/ops/pallas_segment.py:{source_line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": gd["errs"][name],
            "F": F,
            **gd["timing"][(name, F)],
        }
        return entry

    log(f"total {time.perf_counter() - T0:.2f}s")
    kernels = [{
            "name": "bat_segment_sum",
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/edge_row_sum.cu",
            "replaces": "geot_tpu/ops/pallas_segment.py:772",
            "launches": train_launches,
            "launches_by_path": {"serve_requests": serve_launches,
                                 "train_steps": train_launches,
                                 "train_per_step": train_launches // TRAIN_STEPS,
                                 "weight_grad": grad_launches["bat_segment_sum"],
                                 "hybrid_serve_requests": hy["serve"]["bat_segment_sum"],
                                 "hybrid_train_steps": hy["train"]["bat_segment_sum"],
                                 "gin_serve_requests": nr["serve"]["gin"]["bat_segment_sum"],
                                 "gin_train_steps": nr["train"]["gin"]["bat_segment_sum"],
                                 **{f"bucketed_{m}_{k}": bk[k][m]["bat_segment_sum"]
                                    for m in bk["serve"] for k in ("serve", "train")}},
            "max_abs_err": max(max_err, bk["err"]),
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": t_lib,
            "form": "gathered (x[src[e]] read in the kernel)",
            "values_form": {k: t5[k] for k in ("values_ms", "values_bound_ms",
                                               "values_library_ms", "gather_ms")},
            "F40": t5_40,
            "backward": t9,
            "backward_spmm_ms": t_bwd,
            "hybrid_remainder": hy["rest_timing"],
            "bucketed": {f"F{F_}": v for F_, v in bk["timing"].items()},
        }, {
            "name": "sddmm_bat",
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/sddmm_bat.cu",
            "replaces": "geot_tpu/ops/pallas_segment.py:1051",
            "launches": grad_launches["sddmm_bat"],
            "launches_by_path": {"serve_requests": serve_sddmm,
                                 "train_steps": train_sddmm,
                                 "train_per_step": train_sddmm // TRAIN_STEPS,
                                 "weight_grad": grad_launches["sddmm_bat"],
                                 "hybrid_serve_requests": hy["serve"]["sddmm_bat"],
                                 "hybrid_train_steps": hy["train"]["sddmm_bat"]},
            "max_abs_err": max(sddmm_err, grad_err, gd["errs"]["edge_dots"]),
            "ms": t_sk,
            "plain_ms": t_sp,
            "bound_ms": s_bound,
            "bound_by": s_bound_by,
            "library_ms": t_slib,
            "form": "gathered (a[dst[e]] and b[src[e]] read in the kernel)",
            "rows_bound_ms": s_rows_bound,
            "values_form": {"ms": t_sv, "bound_ms": sv_bound, "bound_by": sv_bound_by,
                            "old_route_gather_ms": t_old_gather},
            "edge_dots": {
                "launches_by_path": {f"{m}_{k}": gd[k][m]["edge_dots"]
                                     for m in ("gat", "gcn_dyn64", "gcn_dyn128")
                                     for k in ("serve", "train")},
                **{f"HD{F_}": v for (k, F_), v in gd["timing"].items() if k == "edge_dots"}},
        }, hyb_entry("stream_segment_sum", "sum", 1243),
           hyb_entry("stream_segment_acc", "acc", 1176),
           slot_entry("plan_segment_sum_sr", 1302, 500, "edge_row_sum.cu"),
           slot_entry("plan_segment_sum_sr_packed", 233, 64, "edge_row_sum.cu"),
           slot_entry("plan_segment_sum_pr", 1348, 1),
           new_entry("plan_segment_sum_mh", "edge_row_sum.cu", 1391, 4 * 64),
           new_entry("plan_segment_sum_sr2", "edge_row_sum.cu", 384, 64),
           new_entry("plan_segment_sum_packed2", "edge_row_sum.cu", 581, 64), {
            "name": "bat_segment_sum_packed",
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/edge_row_sum.cu",
            "replaces": "geot_tpu/ops/pallas_segment.py:906",
            "launches": sum(nr["serve"][m]["bat_segment_sum_packed"]
                            + nr["train"][m]["bat_segment_sum_packed"] for m in ("gin", "appnp")),
            "launches_by_path": {f"{m}_{k}": nr[k][m]["bat_segment_sum_packed"]
                                 for m in ("gin", "appnp") for k in ("serve", "train")},
            "max_abs_err": nr["err"],
            **nr["timing"][("gin", "bat")],
            "appnp_F8": nr["timing"][("appnp", "bat")],
            "backward": {m: nr["timing"][(m, "bat_t")] for m in ("gin", "appnp")},
        }, {
            "name": "edge_softmax",
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/edge_softmax.cu",
            "replaces": "geot_tpu/ops/api.py:1562 (GAT's softmax in plain XLA; no TPU kernel)",
            "launches": gd["train"]["gat"]["edge_softmax"],
            "launches_by_path": {"gat_serve_requests": gd["serve"]["gat"]["edge_softmax"],
                                 "gat_train_steps": gd["train"]["gat"]["edge_softmax"]},
            "max_abs_err": max(c["abs"] for c in sm["checks"].values()),
            "ms": sm["timing"]["fwd_ms"],
            "plain_ms": sm["timing"]["plain_fwd_ms"],
            "bound_ms": sm["timing"]["bound_fwd_ms"],
            "bound_by": "bytes",
            "backward": {
                "name": "edge_softmax_grad",
                "launches_by_path": {"gat_train_steps": gd["train"]["gat"]["edge_softmax_grad"]},
                "ms": sm["timing"]["bwd_ms"],
                "plain_ms": sm["timing"]["plain_bwd_ms"],
                "bound_ms": sm["timing"]["bound_bwd_ms"]},
        }]
    # the launches of phases 37 (the sweep; the hybrid candidate) and 38
    # (the compiler pass), per kernel; edge_dots is sddmm_bat's entry
    paths = {"tune_sweep": tu["launches"], **{k: v for k, v in co["launches"].items()}}
    paths["tune_hybrid_clustered"] = tu["launches"].pop("hybrid_clustered")
    # phase 42's (rank 0's): halo_spmm forward and x gradient per layout,
    # the GCN's requests and steps, the NCCL run
    par = p42[0]
    paths.update({f"parallel_halo_{k}": h["launches"] for k, h in par["halo"].items()})
    paths["parallel_gcn_serve_requests"] = par["launches"]["serve"]
    paths["parallel_gcn_train_steps"] = par["launches"]["train"]
    paths["parallel_nccl_halo"] = par["nccl"]["launches"]
    # phases 43-44: the scripts' runs (per run; per rank for train_dist)
    paths.update(p43["launches"])
    for label, out in p44.items():
        for r, launches in enumerate(out["launches"]):
            for k, v in launches.items():
                paths[f"cli_dist_{label}_rank{r}_{k}"] = v
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], p41.get(entry["name"], 0.0))
        for path, counts in paths.items():
            name = entry["name"]
            if counts.get(name):
                entry["launches_by_path"][path] = counts[name]
            if name == "sddmm_bat" and counts.get("edge_dots"):
                entry["edge_dots"]["launches_by_path"][path] = counts["edge_dots"]
            if name == "edge_softmax" and counts.get("edge_softmax_grad"):
                entry["backward"]["launches_by_path"][path] = counts["edge_softmax_grad"]
    print(json.dumps({
        "kernels": kernels,
        "card": smi,
        "forward_ms": t_fwd,
        "spmm_ms": t_spmm,
        "train_step_ms": t_step,
        "train_losses": losses,
        "hybrid": {k: hy[k] for k in ("spmm_ms", "forward_ms", "train_step_ms",
                                      "library_whole_ms", "losses", "families")},
        "slot": {"spmm_ms": sl["spmm_ms"], "forward_ms": sl["forward_ms"],
                 "train_step_ms": sl["train_step_ms"], "losses": sl["losses"],
                 "sr_packed_F7": sl["timing"][("plan_segment_sum_sr_packed", 7)],
                 "busy_share": {f"{m}_{mode}": v for (m, mode), v in sl["busy"].items()}},
        "gat_slot_dyn": {
            "forward_ms": gd["forward_ms"], "train_step_ms": gd["train_step_ms"],
            "losses": gd["losses"],
            "narrow": {f"{k}_F{F}": v for (k, F), v in gd["timing"].items() if F < 64},
            "busy_share": {f"{m}_{mode}": v for (m, mode), v in gd["busy"].items()}},
        "gin_appnp": {
            "forward_ms": nr["forward_ms"], "train_step_ms": nr["train_step_ms"],
            "losses": nr["losses"],
            "busy_share": {f"{m}_{mode}": v for (m, mode), v in nr["busy"].items()}},
        "bucketed": {k: bk[k] for k in ("forward_ms", "train_step_ms", "losses", "reduce_ms",
                                        "build_s", "save_s", "load_s", "file_mb")},
        "native_build_s": nat,
        "tuning": {k: tu[k] for k in ("rows", "best", "hybrid_clustered_ms", "sweep_s")},
        "compiler": {k: v for k, v in co.items() if k != "launches"},
        "c19": c19,
        "edge_softmax": sm,
        "parallel": {
            "partitions": p40, "part_reduce_errs": p41, "part_views_s": p41_view_s,
            "ranks": [{"halo": {k: {"err": h["err"], "build_s": h["build_s"]}
                                for k, h in r["halo"].items()},
                       "gcn": {k: v for k, v in r["gcn"].items()}} for r in p42],
            "nccl": {k: v for k, v in par["nccl"].items() if k != "launches"}},
        "cli": {
            "train": {k: {"row": v["row"], "seconds": v["seconds"], "final_loss": v["meta"]["loss"]}
                      for k, v in p43["train"].items()},
            "time_only": p43["time_only"], "subprocess_s": p43["subprocess_s"],
            "dist": {label: {k: v for k, v in out.items() if k != "launches"}
                     for label, out in p44.items()}},
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
