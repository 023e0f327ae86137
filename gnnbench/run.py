"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, the benchmark
(`gnnbench/`) and the program (`geot_tpu_torch/`). Needs CUDA cards, as
many as the cell asks for; exits with a code other than 0 and prints no
result without them, without the program, or where JAX, flax or the JAX
package (`geot_tpu`) is loaded once the window has closed. The last line
of standard output is the result's JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard
error and the result's last key. Caches (kernel builds, the graph's plans,
the generated edges) stay in fixed directories inside the checkout.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".gnnbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "geot_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's (`geot_tpu_torch` is not `geot_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def _fmt(v) -> str:
    return "none" if v is None else repr(float(v))


def _plain(v):
    """v with every non-finite float written as a string, so the line is
    strict JSON."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "geot_tpu_torch")):
        print("gnnbench: the program (geot_tpu_torch/) is not in this checkout", file=sys.stderr)
        return 3
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    import torch

    from gnnbench.harness.cell import log, run_cell
    from gnnbench.harness.manifest import load_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gnnbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as the configurations state
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"{args.workload} seed {args.seed}: {torch.cuda.get_device_name(device)}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, _T_START, CACHE)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"gnnbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {_fmt(c['value'])} limit {_fmt(c['limit'])}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
