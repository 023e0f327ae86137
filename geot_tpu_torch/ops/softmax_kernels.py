"""The edge softmax of a dst-sorted edge list: the CUDA kernel's wrappers and
plain versions.

GAT's attention from its per-node terms, and `segment_softmax` of per-edge
logits, forward and backward. The kernel is `ops/csrc/edge_softmax.cu` (see
that file for its design and bound), built by nvcc for sm_90a and called
through ctypes. For each destination row i (the edges e with dst[e] = i)
and head h:

    l_e   = leaky_relu(alpha_src[src[e], h] + alpha_dst[i, h])   (or logits[e, h])
    att_e = exp(l_e - m) / max(s, 1e-16),  m = max l_e,  s = sum exp(l_e - m)

and backward, from g = dL/datt: gl_e = att_e (g_e - sum att g) (the
logits' gradient); with the node terms gp_e = gl_e where the pre-activation
is > 0, else gl_e * slope, summed by dst into dalpha_dst and by src (the
src-sorted runs, through perm_t) into dalpha_src.

`edge_softmax` and `edge_softmax_grad` run the plain versions for tensors
on the CPU, in float32 (float64 inputs in float64); for CUDA tensors they
launch the kernel or raise, and count their launches under their names.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from geot_tpu_torch.ops._build import load_kernel

__all__ = ["edge_softmax", "edge_softmax_plain", "edge_softmax_grad",
           "edge_softmax_grad_plain"]


def _lib():
    lib = load_kernel("edge_softmax")
    if lib.geot_edge_softmax_fwd.argtypes is None:
        p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.geot_edge_softmax_chunk.argtypes = []
        lib.geot_edge_softmax_chunk.restype = ctypes.c_int
        lib.geot_edge_softmax_fwd.argtypes = [p, p, i64, i32, i32, p, p, p, p, i32, f32, p, p, p,
                                              i64, p]
        lib.geot_edge_softmax_fwd.restype = ctypes.c_int
        lib.geot_edge_softmax_bwd.argtypes = [p, p, i64, i32, i32, p, p, p, i32, f32, p, p, p, p,
                                              p, p, i64, p, p, p, p, p, p]
        lib.geot_edge_softmax_bwd.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, dtype, shape, dev, what: str) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, dst on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _node_terms(alpha_src, alpha_dst, src, E, n_rows, dev, what):
    """(H, n_src_rows) of the node terms, checked."""
    H = alpha_dst.shape[1] if alpha_dst.dim() == 2 else -1
    n_src_rows = alpha_src.shape[0]
    _check(alpha_src, "alpha_src", torch.float32, (n_src_rows, H), dev, what)
    _check(alpha_dst, "alpha_dst", torch.float32, (n_rows, H), dev, what)
    _check(src, "src", torch.int32, (E,), dev, what)
    return H, n_src_rows


def _scratch(E: int, H: int, dev) -> Tuple[int, torch.Tensor]:
    """(chunks, one [chunks, 2, H] float32 partial buffer) of the kernel's
    edge chunks."""
    n_chunks = -(-E // _lib().geot_edge_softmax_chunk())
    return n_chunks, torch.empty(n_chunks * 2 * H, dtype=torch.float32, device=dev)


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: edge-softmax kernel launch failed: cudaError {rc}")


def _wt(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: float32, or float64 for float64."""
    return torch.promote_types(t.dtype, torch.float32)


def _plain_logits(logits, alpha_src, alpha_dst, src, dst_l, slope):
    if logits is not None:
        return logits.to(_wt(logits))
    wt = _wt(alpha_src)
    x = alpha_src.to(wt)[src.long()] + alpha_dst.to(wt)[dst_l]
    return torch.where(x > 0, x, x * slope)


def edge_softmax_plain(dst: torch.Tensor, dst_ptr: torch.Tensor,
                       logits: Optional[torch.Tensor] = None, *,
                       alpha_src: Optional[torch.Tensor] = None,
                       alpha_dst: Optional[torch.Tensor] = None,
                       src: Optional[torch.Tensor] = None,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """Plain torch `edge_softmax`: the rows' max by `scatter_reduce`, their
    sums by `index_add_` (in edge order on the CPU). Returns [E, H] in the
    working dtype (float32; float64 for float64 inputs)."""
    d = dst.long()
    lg = _plain_logits(logits, alpha_src, alpha_dst, src, d, negative_slope)
    n, H = dst_ptr.shape[0] - 1, lg.shape[1]
    dh = d[:, None].expand(-1, H)
    m = torch.full((n, H), -torch.inf, dtype=lg.dtype, device=lg.device)
    m = m.scatter_reduce(0, dh, lg, "amax")
    e = torch.exp(lg - m[d])
    s = torch.zeros(n, H, dtype=lg.dtype, device=lg.device).index_add_(0, d, e)
    return e / torch.clamp(s[d], min=1e-16)


def edge_softmax(dst: torch.Tensor, dst_ptr: torch.Tensor,
                 logits: Optional[torch.Tensor] = None, *,
                 alpha_src: Optional[torch.Tensor] = None,
                 alpha_dst: Optional[torch.Tensor] = None,
                 src: Optional[torch.Tensor] = None,
                 negative_slope: float = 0.2) -> torch.Tensor:
    """The attention [E, H] float32 of a dst-sorted edge list: dst [E] int32
    ascending, dst_ptr [n_rows + 1] int32 its run boundaries; either the
    per-edge logits [E, H] float32, or the node terms alpha_src [n_src_rows,
    H], alpha_dst [n_rows, H] (float32) and src [E] int32 with
    `negative_slope`. Every row with edges sums to 1.

    CPU tensors run `edge_softmax_plain`; CUDA tensors launch the kernel
    (`ops/csrc/edge_softmax.cu`: a main pass and the cut rows' fix-up) and
    add one to `edge_softmax.launches`."""
    dev = dst.device
    if dev.type == "cpu":
        return edge_softmax_plain(dst, dst_ptr, logits, alpha_src=alpha_src,
                                  alpha_dst=alpha_dst, src=src, negative_slope=negative_slope)
    if dev.type != "cuda":
        raise ValueError(f"edge_softmax: unsupported device {dev}")
    what = "edge_softmax"
    E, n_rows = dst.shape[0], dst_ptr.shape[0] - 1
    _check(dst, "dst", torch.int32, (E,), dev, what)
    _check(dst_ptr, "dst_ptr", torch.int32, (n_rows + 1,), dev, what)
    if logits is not None:
        H = logits.shape[1] if logits.dim() == 2 else -1
        _check(logits, "logits", torch.float32, (E, H), dev, what)
        n_src_rows = 0
    else:
        H, n_src_rows = _node_terms(alpha_src, alpha_dst, src, E, n_rows, dev, what)
    att = torch.empty(E, H, dtype=torch.float32, device=dev)
    if E == 0:
        return att
    n_chunks, pa = _scratch(E, H, dev)
    pb = torch.empty_like(pa)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().geot_edge_softmax_fwd(
            dst.data_ptr(), dst_ptr.data_ptr(), E, n_rows, H, _ptr(logits), _ptr(alpha_src),
            _ptr(alpha_dst), _ptr(src), n_src_rows, float(negative_slope), att.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), n_chunks, stream)
    _rc(rc, what)
    edge_softmax.launches += 1
    return att


def edge_softmax_grad_plain(dst: torch.Tensor, dst_ptr: torch.Tensor, att: torch.Tensor,
                            g: torch.Tensor, *, alpha_src: Optional[torch.Tensor] = None,
                            alpha_dst: Optional[torch.Tensor] = None,
                            src: Optional[torch.Tensor] = None,
                            negative_slope: float = 0.2,
                            perm_t: Optional[torch.Tensor] = None,
                            src_t: Optional[torch.Tensor] = None,
                            src_ptr: Optional[torch.Tensor] = None):
    """Plain torch `edge_softmax_grad`: the rows' sums by `index_add_` (by
    dst in edge order; dalpha_src over src_t's runs through perm_t, in
    src-sorted order)."""
    d = dst.long()
    wt = _wt(att)
    att, g = att.to(wt), g.to(wt)
    n, H = dst_ptr.shape[0] - 1, att.shape[1]
    r = torch.zeros(n, H, dtype=wt, device=att.device).index_add_(0, d, att * g)
    gl = att * (g - r[d])
    if alpha_src is None:
        return gl
    x = alpha_src.to(wt)[src.long()] + alpha_dst.to(wt)[d]
    gp = torch.where(x > 0, gl, gl * negative_slope)
    dad = torch.zeros(n, H, dtype=wt, device=att.device).index_add_(0, d, gp)
    das = None
    if perm_t is not None:
        das = torch.zeros(src_ptr.shape[0] - 1, H, dtype=wt, device=att.device)
        das.index_add_(0, src_t.long(), gp.index_select(0, perm_t.long()))
    return das, dad


def edge_softmax_grad(dst: torch.Tensor, dst_ptr: torch.Tensor, att: torch.Tensor,
                      g: torch.Tensor, *, alpha_src: Optional[torch.Tensor] = None,
                      alpha_dst: Optional[torch.Tensor] = None,
                      src: Optional[torch.Tensor] = None, negative_slope: float = 0.2,
                      perm_t: Optional[torch.Tensor] = None,
                      src_t: Optional[torch.Tensor] = None,
                      src_ptr: Optional[torch.Tensor] = None):
    """The backward of `edge_softmax` over the same dst and dst_ptr, from
    its att [E, H] and g = dL/datt [E, H] (float32): the per-edge logits'
    gradient [E, H], or with the node terms (as forward) the pair
    (dalpha_src [n_src_rows, H] or None, dalpha_dst [n_rows, H]).
    dalpha_src is computed where perm_t [E] int32 (the dst-sorted position
    of each src-sorted edge), src_t [E] int32 (src[perm_t], ascending) and
    src_ptr [n_src_rows + 1] int32 (its run boundaries) are given. Every
    sum is in a fixed order, with no atomics on the card.

    CPU tensors run `edge_softmax_grad_plain`; CUDA tensors launch the
    kernel (with the node terms: the dst pass, its fix-up, the src pass and
    the cut rows' sums, after zeroing both outputs) and add one to
    `edge_softmax_grad.launches`."""
    dev = dst.device
    kw = dict(alpha_src=alpha_src, alpha_dst=alpha_dst, src=src, negative_slope=negative_slope,
              perm_t=perm_t, src_t=src_t, src_ptr=src_ptr)
    if dev.type == "cpu":
        return edge_softmax_grad_plain(dst, dst_ptr, att, g, **kw)
    if dev.type != "cuda":
        raise ValueError(f"edge_softmax_grad: unsupported device {dev}")
    what = "edge_softmax_grad"
    E, n_rows = dst.shape[0], dst_ptr.shape[0] - 1
    H = att.shape[1] if att.dim() == 2 else -1
    _check(dst, "dst", torch.int32, (E,), dev, what)
    _check(dst_ptr, "dst_ptr", torch.int32, (n_rows + 1,), dev, what)
    _check(att, "att", torch.float32, (E, H), dev, what)
    _check(g, "g", torch.float32, (E, H), dev, what)
    node = alpha_src is not None
    n_src_rows = 0
    dad = das = ps = None
    if node:
        hn, n_src_rows = _node_terms(alpha_src, alpha_dst, src, E, n_rows, dev, what)
        if hn != H:
            raise ValueError(f"{what}: att has {H} heads, the node terms {hn}")
        dad = torch.zeros(n_rows, H, dtype=torch.float32, device=dev)
        if perm_t is not None:
            _check(perm_t, "perm_t", torch.int32, (E,), dev, what)
            _check(src_t, "src_t", torch.int32, (E,), dev, what)
            _check(src_ptr, "src_ptr", torch.int32, (n_src_rows + 1,), dev, what)
            das = torch.zeros(n_src_rows, H, dtype=torch.float32, device=dev)
    gout = torch.empty(E, H, dtype=torch.float32, device=dev)
    if E > 0:
        n_chunks, pa = _scratch(E, H, dev)
        pb = torch.empty_like(pa)
        if das is not None:
            ps = torch.empty_like(pa)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().geot_edge_softmax_bwd(
                dst.data_ptr(), dst_ptr.data_ptr(), E, n_rows, H, _ptr(alpha_src),
                _ptr(alpha_dst), _ptr(src), n_src_rows, float(negative_slope), att.data_ptr(),
                g.data_ptr(), gout.data_ptr(), _ptr(dad), pa.data_ptr(), pb.data_ptr(),
                n_chunks, _ptr(perm_t if das is not None else None), _ptr(src_t),
                _ptr(src_ptr), _ptr(das), _ptr(ps), stream)
        _rc(rc, what)
        edge_softmax_grad.launches += 1
    return (das, dad) if node else gout


edge_softmax.launches = 0
edge_softmax_grad.launches = 0
