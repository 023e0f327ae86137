"""Drive geot_tpu_torch on one CUDA card: build the kernels, hold each
against its plain version, serve GCN inference requests, time them.

    python3 chip_smoke.py

Runs the port's main path at full width: a 3-layer GCN (hidden 128,
40 classes) over an ogbn-arxiv-shaped synthetic graph (169,343 nodes,
1,166,243 edges + self-loops, 128 features), weights from a seeded
torch.Generator. Phases, each printed with its elapsed seconds:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build (nvcc, sm_90a) with its ptxas report;
  3. bat_segment_sum against bat_segment_sum_plain on the card at the real
     plan (F_pad 128), weighted and unweighted, and through a plan forced
     into chunks with a split hub window;
  4. 5 inference requests (GCN forward passes), counting kernel launches,
     each held against the same model on the plain reference path;
  5. CUDA-event timings of the kernel, its plain version, the library
     yardstick (torch.sparse.mm, never called by the port), one SpMM and
     one forward pass, beside the card's name and power limit.

Prints one JSON line of per-kernel results, then as the last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0); a phase
that stalls past its budget ends the process. Needs a CUDA card: it never
falls back to the CPU.
"""

import faulthandler
import json
import subprocess
import sys
import time

import torch

T0 = time.perf_counter()
SEED = 0
REQUESTS = 5
PHASE_BUDGET_S = {"build": 200, "kernel": 120, "serve": 180, "timing": 120}
# kernel vs plain: two f32 sums of the same terms in different orders (the
# kernel in edge order, the plain index_add_ with atomics). Allowed error
# per element: 1e-4 * sum|w_e * v_e| + 1e-5, about 1700 f32 roundings of
# the row's magnitude — above the sqrt(n)*u growth of a ~92k-term hub row.
KERNEL_RTOL_ABS_SUM, KERNEL_ATOL = 1e-4, 1e-5
# GCN outputs (O(1) values): kernel path vs the plain reference path
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr, flush=True)
        return 2
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import compute_chunks, with_chunks
    from geot_tpu_torch.models import GCN, gcn_edge_weight, prepare_graph
    from geot_tpu_torch.ops import api
    from geot_tpu_torch.ops._build import build_kernels
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

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
    g = prepare_graph(data.src, data.dst, n, device=dev)
    bp = g.bat
    n_chunks = max(len(bp.chunks), 1)
    deg = torch.bincount(g.dst.long(), minlength=n)
    log(f"graph: {n} nodes, {g.num_edges} edges (self-loops added), plan "
        f"{bp.num_tiles} tiles e_tile={bp.e_tile} s_tile={bp.s_tile} "
        f"{bp.n_blocks} windows, chunks={n_chunks}; head window "
        f"{int(deg[:bp.s_tile].sum())} edges, max in-degree {int(deg.max())}")
    x = torch.from_numpy(data.x).to(dev)

    # 3. kernel vs plain at the real plan, F_pad 128
    arm("kernel")
    w_gcn = gcn_edge_weight(g)
    src_pad = torch.nn.functional.pad(
        g.src.long(), (0, bp.n_vblocks * bp.e_tile - g.num_edges))
    vals = x.index_select(0, src_pad)  # [n_vblocks*e_tile, 128], edge order
    max_err = 0.0
    for label, w in (("weighted", w_gcn), ("unweighted", None)):
        k = bat_segment_sum(bp, vals, w)
        torch.cuda.synchronize()
        p = bat_segment_sum_plain(bp, vals, w)
        a = bat_segment_sum_plain(bp, vals.abs(), None if w is None else w.abs())
        max_err = max(max_err, check_close_abs_sum(k, p, a, f"phase 3 kernel {label}"))
        k2 = bat_segment_sum(bp, vals, w)
        if not torch.equal(k, k2):
            raise AssertionError("kernel is not deterministic")
    hub_w = int(torch.bincount(bp.out_block.long()).argmax())
    cap = max(int(torch.bincount(bp.out_block.long()).max()) // 3, 2)
    ch = compute_chunks(bp.out_block.cpu().numpy(), cap)
    split = [(a[3], b[2]) for a, b in zip(ch[:-1], ch[1:]) if b[2] < a[3]]
    if len(ch) < 3 or not split:
        raise AssertionError("forced chunking did not split a hub window")
    bpc = with_chunks(bp, ch)
    with torch.inference_mode():
        ref_rows = bat_segment_sum_plain(bp, vals, w_gcn)[:n]
        got = api._spmm_fwd_bat(bpc, x, g.src, w_gcn)
        a = bat_segment_sum_plain(bp, vals.abs(), w_gcn.abs())[:n]
    max_err = max(max_err, check_close_abs_sum(
        got, ref_rows, a, f"phase 3 chunked ({len(ch)} chunks, hub window {hub_w} split)"))
    del vals, k, k2, p, a, ref_rows, got

    # 4. serve: GCN inference requests
    arm("serve")
    gen = torch.Generator().manual_seed(SEED)
    model = GCN(f, 128, 3, c, generator=gen, device=dev).eval()
    ref_model = GCN(f, 128, 3, c, backend="reference", device=dev).eval()
    ref_model.load_state_dict(model.state_dict())
    outs, req_s = [], []
    bat_segment_sum.launches = 0  # count the main path's launches only
    with torch.inference_mode():
        for i in range(REQUESTS):
            before = bat_segment_sum.launches
            ts = time.perf_counter()
            out = model(x, g)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - ts)
            if bat_segment_sum.launches - before != 3 * n_chunks:
                raise AssertionError(
                    f"request {i}: {bat_segment_sum.launches - before} kernel launches, "
                    f"expected 3 x {n_chunks}")
            outs.append(out)
    launches = bat_segment_sum.launches
    log(f"phase 4 serve: {REQUESTS} requests, bat_segment_sum launches={launches} "
        f"(3 layers x {n_chunks} chunk(s) each); request s: "
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

    # 5. timing
    arm("timing")
    vals = x.index_select(0, src_pad)
    nnz, F = g.num_edges, vals.shape[1]
    t_k = cuda_ms(lambda: bat_segment_sum(bp, vals, w_gcn))
    t_p = cuda_ms(lambda: bat_segment_sum_plain(bp, vals, w_gcn), iters=5)
    adj = torch.sparse_coo_tensor(
        torch.stack([g.dst.long(), g.src.long()]), w_gcn, (n, n),
        check_invariants=False).coalesce().to_sparse_csr()
    t_lib = cuda_ms(lambda: torch.sparse.mm(adj, x))
    with torch.inference_mode():
        t_spmm = cuda_ms(lambda: api.segment_spmm(g, x, edge_weight=w_gcn))
        t_fwd = cuda_ms(lambda: model(x, g), iters=5)
    # bound: each input read once, each output written once (bytes), and
    # 2 flops per weighted value (f32, no tensor cores)
    n_bytes = (nnz * F * 4 + (bp.n_vblocks + 1) * bp.e_tile * 4 + nnz * 4
               + bp.num_tiles * 8 + bp.n_blocks * bp.s_tile * F * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * nnz * F / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    log(f"{card} bat_segment_sum kernel {t_k:.4f} ms (bound {bound:.4f} ms by "
        f"{'bytes' if t_bytes >= t_ops else 'operations'}: {n_bytes / 1e9:.3f} GB)")
    log(f"{card} bat_segment_sum_plain {t_p:.4f} ms")
    log(f"{card} library torch.sparse.mm (CSR adjacency @ x, whole SpMM) {t_lib:.4f} ms")
    log(f"{card} segment_spmm (gather + kernel, one layer's SpMM) {t_spmm:.4f} ms")
    log(f"{card} GCN forward (3 layers) {t_fwd:.4f} ms; request wall "
        f"{min(req_s) * 1e3:.4f} ms min")
    faulthandler.cancel_dump_traceback_later()

    print(json.dumps({
        "kernels": [{
            "name": "bat_segment_sum",
            "route": "cuda",
            "source": "geot_tpu_torch/ops/csrc/bat_segment_sum.cu",
            "replaces": "geot_tpu/ops/pallas_segment.py:730",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t_lib,
        }],
        "launches": {"bat_segment_sum": launches},
        "card": smi,
        "forward_ms": t_fwd,
        "spmm_ms": t_spmm,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
