"""ctypes bindings for the port's native C++ host runtime (src/geot_native.cc).

Port of `geot_tpu/native/__init__.py`: the counting sort, the slot plan's
arrays, the BAT plan's (window, value block) tiles, the MatrixMarket reader
and the CSR row pointer, each an O(nnz) multithreaded pass over host
arrays. The port keeps its own copy of the source and builds it on first
use with

    g++ -O3 -shared -fPIC -std=c++17 -pthread -o <lib>.so geot_native.cc

into `<checkout>/build/geot_tpu_torch/`, the library named by a hash of the
source and the flags. It is compiled to a temporary name and moved into
place with `os.replace`, so a process never loads a half-written library
while another builds it (the reference writes its `.so` in place beside the
source). `python -m geot_tpu_torch.native` builds eagerly.

Every entry point returns None where g++ or the load fails, and the callers
(`graph.plan`, `graph.structures`) then run their numpy branch, which gives
the same arrays. `disabled()` switches the native runtime off inside a
`with` block, for comparisons and timings of the numpy branch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "build",
    "disabled",
    "sort_by_key",
    "build_plan_arrays",
    "build_bat_tiles",
    "read_mtx",
    "coo_to_csr_host",
]

_SRC = Path(__file__).resolve().parent / "src" / "geot_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "geot_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_off = 0  # depth of `disabled()` blocks


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libgeot_native_{tag}.so"


def build(verbose: bool = False, force: bool = False) -> bool:
    """Compile the shared library unless it is built (or `force`).
    Returns True when the library is in place."""
    path = _lib_path()
    if path.exists() and not force:
        return True
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    tmp = path.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            if verbose:
                print(res.stderr)
            return False
        os.replace(tmp, path)  # atomic: readers never see a partial library
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    sigs = {
        "geot_sort_by_key": (ctypes.c_int, [i32p, i64, i32, i32p]),
        "geot_plan_num_tiles": (i64, [i32p, i64, i32, i32, i32]),
        "geot_build_plan": (ctypes.c_int,
                            [i32p, i32p, i64, i32, i32, i32, i32p, i32p, i32p, f32p, i32p]),
        "geot_mtx_open": (i64, [ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
                                ctypes.POINTER(ctypes.c_int)]),
        "geot_mtx_read": (i64, [ctypes.c_char_p, i32p, i32p, f32p, i64]),
        "geot_coo_to_csr": (ctypes.c_int, [i32p, i64, i32, i32p]),
        "geot_bat_num_tiles": (i64, [i32p, i64, i32, i32, i32]),
        "geot_build_bat_tiles": (ctypes.c_int, [i32p, i64, i32, i32, i32, i32p, i32p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _off:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(_lib_path())))
        except (OSError, AttributeError):
            return None
        return _lib


def available() -> bool:
    return _load() is not None


@contextlib.contextmanager
def disabled():
    """Every entry point returns None (the numpy branch) inside the block."""
    global _off
    _off += 1
    try:
        yield
    finally:
        _off -= 1


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sort_by_key(key: np.ndarray, num_keys: int) -> Optional[np.ndarray]:
    """Stable counting-sort permutation by int32 key (int32), or None (a
    key outside [0, num_keys), or no native runtime)."""
    lib = _load()
    if lib is None:
        return None
    key = np.ascontiguousarray(key, dtype=np.int32)
    perm = np.empty(len(key), dtype=np.int32)
    rc = lib.geot_sort_by_key(_i32p(key), len(key), int(num_keys), _i32p(perm))
    return perm if rc == 0 else None


def build_plan_arrays(
    dst_sorted: np.ndarray,
    src: Optional[np.ndarray],
    num_segments: int,
    e_tile: int,
    s_tile: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """A slot plan's arrays at pack_align 1: (src_slots, dst_slots,
    edge_pos, mask, out_block), or None."""
    lib = _load()
    if lib is None:
        return None
    dst_sorted = np.ascontiguousarray(dst_sorted, dtype=np.int32)
    nnz = len(dst_sorted)
    num_tiles = lib.geot_plan_num_tiles(_i32p(dst_sorted), nnz, int(num_segments),
                                        int(e_tile), int(s_tile))
    if num_tiles < 0:
        return None
    te = int(num_tiles) * e_tile
    src_c = None if src is None else np.ascontiguousarray(src, dtype=np.int32)
    src_slots = np.empty(te, np.int32)
    dst_slots = np.empty(te, np.int32)
    edge_pos = np.empty(te, np.int32)
    mask = np.empty(te, np.float32)
    out_block = np.empty(int(num_tiles), np.int32)
    rc = lib.geot_build_plan(
        _i32p(dst_sorted), None if src_c is None else _i32p(src_c), nnz, int(num_segments),
        int(e_tile), int(s_tile), _i32p(src_slots), _i32p(dst_slots), _i32p(edge_pos),
        _f32p(mask), _i32p(out_block),
    )
    if rc != 0:
        return None
    shape = (int(num_tiles), e_tile)
    return (src_slots.reshape(shape), dst_slots.reshape(shape), edge_pos.reshape(shape),
            mask.reshape(shape), out_block)


def build_bat_tiles(
    dst_sorted: np.ndarray,
    num_segments: int,
    e_tile: int,
    s_tile: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A BAT plan's (window, value block) tiles (out_block, vblock), with
    the coverage tiles of empty windows, or None."""
    lib = _load()
    if lib is None:
        return None
    dst_sorted = np.ascontiguousarray(dst_sorted, dtype=np.int32)
    nnz = len(dst_sorted)
    t = lib.geot_bat_num_tiles(_i32p(dst_sorted), nnz, int(num_segments), int(e_tile),
                               int(s_tile))
    if t < 0:
        return None
    ob = np.empty(int(t), np.int32)
    vb = np.empty(int(t), np.int32)
    rc = lib.geot_build_bat_tiles(_i32p(dst_sorted), nnz, int(num_segments), int(e_tile),
                                  int(s_tile), _i32p(ob), _i32p(vb))
    return (ob, vb) if rc == 0 else None


def read_mtx(path: str):
    """MatrixMarket coordinate file -> (row, col, val, num_rows, num_cols),
    0-based, a symmetric file's off-diagonal entries mirrored; or None."""
    lib = _load()
    if lib is None:
        return None
    rows, cols, sym = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    cap = lib.geot_mtx_open(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                            ctypes.byref(sym))
    if cap < 0:
        return None
    row = np.empty(int(cap), np.int32)
    col = np.empty(int(cap), np.int32)
    val = np.empty(int(cap), np.float32)
    n = lib.geot_mtx_read(path.encode(), _i32p(row), _i32p(col), _f32p(val), cap)
    if n < 0:
        return None
    return row[:n], col[:n], val[:n], int(rows.value), int(cols.value)


def coo_to_csr_host(dst_sorted: np.ndarray, num_rows: int) -> Optional[np.ndarray]:
    """The [num_rows + 1] row pointer of dst-sorted rows, or None."""
    lib = _load()
    if lib is None:
        return None
    dst_sorted = np.ascontiguousarray(dst_sorted, dtype=np.int32)
    out = np.empty(num_rows + 1, np.int32)
    rc = lib.geot_coo_to_csr(_i32p(dst_sorted), len(dst_sorted), int(num_rows), _i32p(out))
    return out if rc == 0 else None
