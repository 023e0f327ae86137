"""The port's native host runtime against its numpy branch and the JAX
package's numpy builders.

Mirrors tests/test_native.py. The JAX package's builders run with its
native runtime switched off (`geot_tpu.native._load` patched to return
None), so these tests never build or load the JAX package's library; the
port's numpy branch runs inside `native.disabled()`. Every array must be
equal, not close. The last test starts two processes that build the
port's library at once: each must load a sound library (the build writes a
temporary file and moves it into place).
"""

import subprocess
import sys

import numpy as np
import pytest

import geot_tpu.graph.plan as jplan
from geot_tpu import native as jnative
from geot_tpu_torch import native
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph

pytestmark = pytest.mark.skipif(not native.available(), reason="g++ or the load failed")


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's builders on their numpy branch."""
    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.mark.parametrize("n,e,et,st", [(100, 700, 64, 64), (257, 1301, 128, 256),
                                       (50, 0, 32, 32), (3000, 20_000, 512, 256)])
@pytest.mark.parametrize("with_src", [True, False])
def test_plan_native_equals_numpy(jax_numpy, n, e, et, st, with_src):
    """Slot plans at pack_align 1: native == the port's numpy == JAX's numpy."""
    rng = np.random.default_rng(0)
    dst = np.sort(rng.integers(0, n, e).astype(np.int32))
    src = rng.integers(0, n, e).astype(np.int32) if with_src else None
    kw = dict(e_tile=et, s_tile=st, num_src_nodes=n if with_src else None, pack_align=1,
              max_chunk_slots=8 * et)
    a_nat, m_nat = tplan.build_segment_plan_host(dst, src, n, **kw)
    with native.disabled():
        a_np, m_np = tplan.build_segment_plan_host(dst, src, n, **kw)
    a_j, m_j = jplan.build_segment_plan_host(dst, src, n, **kw)
    assert m_nat == m_np == m_j
    assert set(a_nat) == set(a_np) == set(a_j)
    for f in a_nat:
        np.testing.assert_array_equal(a_nat[f], a_np[f], err_msg=f)
        np.testing.assert_array_equal(a_nat[f], a_j[f], err_msg=f)
        assert a_nat[f].dtype == a_np[f].dtype, f


def test_sort_by_key_stable():
    rng = np.random.default_rng(1)
    key = rng.integers(0, 37, 5000).astype(np.int32)
    perm = native.sort_by_key(key, 37)
    assert perm is not None and perm.dtype == np.int32
    np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    with native.disabled():
        assert native.sort_by_key(key, 37) is None


def test_sort_rejects_out_of_range():
    key = np.array([0, 5, 2], np.int32)
    assert native.sort_by_key(key, 3) is None
    assert jnative.sort_by_key is not None  # the JAX package's is never called here


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_mtx_round_trip(tmp_path):
    p = _write(tmp_path / "t.mtx", "%%MatrixMarket matrix coordinate real general\n"
               "% comment\n4 4 5\n1 2 1.5\n2 1 -2.0\n3 3 0.5\n4 1 7.0\n4 4 1.0\n")
    row, col, val, nr, nc = native.read_mtx(p)
    assert (nr, nc) == (4, 4)
    np.testing.assert_array_equal(row, [0, 1, 2, 3, 3])
    np.testing.assert_array_equal(col, [1, 0, 2, 0, 3])
    np.testing.assert_allclose(val, [1.5, -2.0, 0.5, 7.0, 1.0])
    assert native.read_mtx(str(tmp_path / "missing.mtx")) is None


def test_mtx_symmetric_pattern(tmp_path):
    p = _write(tmp_path / "s.mtx", "%%MatrixMarket matrix coordinate pattern symmetric\n"
               "3 3 3\n1 1\n2 1\n3 2\n")
    row, col, val, nr, nc = native.read_mtx(p)
    # the diagonal once, the off-diagonal entries mirrored
    assert sorted(zip(row.tolist(), col.tolist())) == [(0, 0), (0, 1), (1, 0), (1, 2), (2, 1)]
    np.testing.assert_array_equal(val, np.ones(5, np.float32))
    assert (nr, nc) == (3, 3)


def test_coo_to_csr_host():
    dst = np.array([0, 0, 1, 3, 3, 3], np.int32)
    np.testing.assert_array_equal(native.coo_to_csr_host(dst, 5), [0, 2, 3, 3, 6, 6])
    rng = np.random.default_rng(4)
    dst = np.sort(rng.integers(0, 300, 4000)).astype(np.int32)
    want = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=300))])
    np.testing.assert_array_equal(native.coo_to_csr_host(dst, 300), want)


@pytest.mark.parametrize("nnz,n_seg,e_tile,s_tile", [
    (3003, 400, 64, 64),
    (10_000, 257, 128, 256),
    (513, 4000, 64, 128),  # many empty windows
    (7, 1000, 64, 64),
])
@pytest.mark.parametrize("km_pack", [0, 4])
def test_bat_tiles_match_numpy(jax_numpy, nnz, n_seg, e_tile, s_tile, km_pack):
    """BAT plans: native tiles == the port's numpy == JAX's numpy, the
    whole host plan (dst3, dst_km, chunks) too."""
    rng = np.random.default_rng(11)
    dst = np.sort(rng.integers(0, n_seg, nnz)).astype(np.int32)
    ob_n, vb_n = native.build_bat_tiles(dst, n_seg, e_tile, s_tile)
    with native.disabled():
        ob_p, vb_p = tplan._bat_tiles(dst, n_seg, e_tile, s_tile)
    np.testing.assert_array_equal(ob_n, ob_p)
    np.testing.assert_array_equal(vb_n, vb_p)
    kw = dict(e_tile=e_tile, s_tile=s_tile, km_pack=km_pack, max_chunk_tiles=16)
    a_t, m_t = tplan.build_bat_plan_host(dst, n_seg, **kw)
    a_j, m_j = jplan.build_bat_plan_host(dst, n_seg, **kw)
    assert m_t == m_j
    for f in a_t:
        np.testing.assert_array_equal(a_t[f], a_j[f], err_msg=f)


def test_build_graph_native_equals_numpy():
    """A whole build (slot plans at pack_align 1, BAT, bucketed BAT with
    the bucket sort, the two dst/src sorts): every tensor equal with and
    without the native runtime."""
    rng = np.random.default_rng(5)
    n, e = 700, 6000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    kw = dict(edge_weight=w, e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32,
              layouts=("bat", "slot"), bucket_table_bytes=1, bucket_rows=200, device="cpu")
    g_nat = tbuild_graph(src, dst, n, **kw)
    with native.disabled():
        g_np = tbuild_graph(src, dst, n, **kw)
    for name in ("src", "dst", "perm_t", "dst_t", "edge_weight", "edge_pos_t", "w_slots"):
        assert bool((getattr(g_nat, name) == getattr(g_np, name)).all()), name
    for name in ("plan", "plan_t", "bat", "bat_t", "bat_b", "bat_b_t"):
        p_nat, p_np = getattr(g_nat, name), getattr(g_np, name)
        for f in ("out_block", "dst_slots", "src_slots", "mask", "vblock", "dst3"):
            if hasattr(p_nat, f):
                assert bool((getattr(p_nat, f) == getattr(p_np, f)).all()), (name, f)
        assert p_nat.chunks == p_np.chunks, name


def test_reference_bucketed_numpy_branch_raises(jax_numpy):
    """The JAX package's bucketed builder fails on its numpy branch
    (`np.arange(n_blocks, np.int32)` at geot_tpu/graph/plan.py:768: the
    dtype taken as the stop); the port's numpy branch builds the plan the
    native runtime builds."""
    rng = np.random.default_rng(6)
    n, e = 500, 3000
    d_ = np.sort(rng.integers(0, n, e)).astype(np.int32)
    s_ = rng.integers(0, n, e).astype(np.int32)
    kw = dict(e_tile=64, s_tile=32, bucket_rows=200)
    with pytest.raises(TypeError):
        jplan.build_bucketed_bat_plan(s_, d_, n, n, **kw)
    a_nat, m_nat = tplan.build_bucketed_bat_plan_host(s_, d_, n, n, **kw)
    with native.disabled():
        a_np, m_np = tplan.build_bucketed_bat_plan_host(s_, d_, n, n, **kw)
    assert m_nat == m_np
    for f in a_nat:
        np.testing.assert_array_equal(a_nat[f], a_np[f], err_msg=f)


_CHILD = """
import ctypes, sys
import numpy as np
from geot_tpu_torch import native
assert native.build(force=True), "build failed"
assert native.available()
key = np.random.default_rng(int(sys.argv[1])).integers(0, 50, 100_000).astype(np.int32)
assert (native.sort_by_key(key, 50) == np.argsort(key, kind="stable")).all()
ctypes.CDLL(str(native._lib_path()))  # the file in place is a whole library
print("ok")
"""


def test_two_processes_build_at_once():
    """Two processes compile the library at the same moment; each moves
    its own temporary file into place and loads a sound library."""
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0 and out.strip().endswith("ok"), err[-2000:]
    assert not list(native._BUILD_DIR.glob("libgeot_native_*.tmp*"))
