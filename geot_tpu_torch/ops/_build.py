"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `ops/csrc/` has a plain C interface and is compiled on
first use, one `nvcc` per source (all started together), into a shared
library under `<checkout>/build/geot_tpu_torch/`, named by a hash of the
source, the headers under `ops/csrc/` and the flags so that a stale library
is never loaded (each build and load is timed as the set-up phase
"kernels", `utils.trace`):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

`torch.utils.cpp_extension` is not used: a source that includes PyTorch's
headers takes minutes to compile, a plain C one seconds. Nothing is built
or loaded at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

from geot_tpu_torch.utils.trace import setup_phase

__all__ = ["SOURCES", "build_kernels", "load_kernel"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "geot_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300

# kernel name -> source file under ops/csrc/
SOURCES: Dict[str, str] = {
    "sddmm_bat": "sddmm_bat.cu",
    "stream_segment": "stream_segment.cu",
    "slot_segment_sum": "slot_segment_sum.cu",
    "edge_row_sum": "edge_row_sum.cu",
    "edge_softmax": "edge_softmax.cu",
}

# loaded libraries of this process, by kernel name
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{tag}.so"


def build_kernels(names=None, verbose: bool = True) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel. Returns {name: (seconds, ptxas report)} for those built now;
    prints each report once. Raises RuntimeError if any build fails or
    outlasts NVCC_TIMEOUT_S."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    try:
        for n, (tmp, p) in procs.items():
            left = max(NVCC_TIMEOUT_S - (time.perf_counter() - t0), 1.0)
            try:
                out, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append(f"{n}: nvcc timed out after {NVCC_TIMEOUT_S}s\n{out}")
                continue
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exited {p.returncode}\n{out}")
                continue
            os.replace(tmp, _lib_path(n))  # atomic: readers never see a partial .so
            reports[n] = (time.perf_counter() - t0, out.strip())
    finally:
        for n, (tmp, p) in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    if verbose:
        for n, (secs, rep) in reports.items():
            print(f"[geot_tpu_torch] built {n} in {secs:.2f}s\n{rep}",
                  file=sys.stderr, flush=True)
    return reports


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, building it if needed
    (the set-up phase "kernels": the build and the load)."""
    lib = _LIBS.get(name)
    if lib is None:
        with setup_phase("kernels"):
            build_kernels([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
