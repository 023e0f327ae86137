"""Pattern-match-and-replace pass over a traced PyTorch program.

Port of `geot_tpu/compiler/match_replace.py` (`pattern_transform`,
`count_matches`), in GeoT's own form: the reference project rewrites an
exported FX graph (`geot/match_replace/match_replace.py:8-33`), and so does
this pass. `pattern_transform(fn, graph)` traces `fn` on its first call's
arguments with `make_fx` over `torch.func.functionalize(fn)`, which gives
aten ops with real shapes and turns `out.index_add_(...)` into the
functional `aten.index_add`. It then replaces every message-passing
subgraph it recognises by the port's fused op over the prebuilt `Graph`:

    x[src] * w[:, None] -> index_add / scatter_add   gather_weight_scatter
    x[src]              -> index_add / scatter_add   gather_scatter
    x[src] * w[:, :, None] (x [n, H, D], w [nnz, H]) mh_spmm

`x[src]` is `aten.index_select` or `aten.index.Tensor`; the pass looks
through the shape ops the reference passes through (view, reshape,
unsqueeze, squeeze, expand, `_to_copy`, clone) to find the gather, the
weight and the 1-D index. On the card the fused ops run the hand-written
kernels (`bat_segment_sum`, or `plan_segment_sum_sr2` / `_packed2` on a
`slot_dyn` graph, with `sddmm_bat` for the weights' gradient;
`plan_segment_sum_mh` for the multi-head form); gradients flow through
their autograd Functions. The rewritten `GraphModule` drops the dead
producers (`eliminate_dead_code()`, as GeoT does) and is cached by the
arguments' shapes, dtypes and devices: a second call with the same shapes
does not trace again.

Contract (the reference's): the traced src and dst are the graph's own
dst-sorted edge arrays (`graph.src`, `graph.dst`). A pattern whose output
row count is not `graph.num_nodes`, whose x has another row count, or
whose edge count is not `graph.num_edges` is left alone, and so is
everything else. The shapes alone do not tell `x[src] -> dst` from the
transposed `x[dst] -> src` or from another edge list of the same size, so
at trace time the pass evaluates each candidate's two indices on the
example arguments and rewrites only where the scatter index equals
`graph.dst` and the gather index `graph.src`. Where an index comes from an
argument, a later call whose argument is not the traced tensor (or was
changed in place) and holds other values traces again. A scatter's base that is not a
zeros tensor is added back to the fused op's output. Tensors `fn` closes
over are traced as constants: pass what is to be differentiated as an
argument.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from geot_tpu_torch.graph.structures import Graph
from geot_tpu_torch.ops import api as ops

__all__ = ["pattern_transform", "count_matches"]

aten = torch.ops.aten
_PASSTHROUGH = {"view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "expand",
                "_to_copy", "clone", "alias"}
_ZEROS = {"zeros", "zeros_like", "new_zeros"}


def _op(node: torch.fx.Node) -> Optional[str]:
    if node.op != "call_function" or not hasattr(node.target, "overloadpacket"):
        return None
    return node.target.overloadpacket.__name__


def _shape(node) -> Optional[tuple]:
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def _origin(node: torch.fx.Node) -> torch.fx.Node:
    """Back through shape-only ops to the node that made the values."""
    for _ in range(8):
        if _op(node) not in _PASSTHROUGH:
            break
        node = node.args[0]
    return node


def _strip_expand(node: torch.fx.Node) -> torch.fx.Node:
    while _op(node) == "expand":
        node = node.args[0]
    return node


class _Rewriter:
    def __init__(self, gm: torch.fx.GraphModule, graph: Graph, backend: str):
        self.gm, self.graph, self.backend = gm, graph, backend
        self.matches = 0

    def _index_1d(self, node, nnz: int) -> Optional[torch.fx.Node]:
        """The 1-D index of nnz entries that `node` broadcasts (every step
        down from it keeps nnz rows), else None."""
        chain = [node]
        while _op(chain[-1]) in _PASSTHROUGH:
            chain.append(chain[-1].args[0])
        shapes = [_shape(n) for n in chain]
        ok = shapes[-1] == (nnz,) and all(
            s is not None and s[0] == nnz and (_op(n) == "expand" or set(s[1:]) <= {1})
            for n, s in zip(chain, shapes))
        return chain[-1] if ok else None

    def _gather(self, node, nnz: int):
        """(x, idx) nodes if `node` is (a shape op of) x[idx] with a 1-D
        index of nnz entries along rows, else None."""
        node = _origin(node)
        op = _op(node)
        if op == "index_select":
            x, dim, idx = node.args[:3]
            if dim != 0:
                return None
        elif op == "index" and node.target == aten.index.Tensor:
            x, indices = node.args[:2]
            if len(indices) != 1 or indices[0] is None:
                return None
            idx = indices[0]
        else:
            return None
        if _shape(idx) != (nnz,) or _shape(x) is None:
            return None
        return x, idx

    def match(self, node: torch.fx.Node):
        """(kind, x, weight, base, add_base, scatter index, gather index)
        of a scatter-add whose shapes match, or None."""
        op = _op(node)
        g = self.graph
        nnz = g.num_edges
        if op == "index_add":
            base, dim, index, upd = node.args[:4]
            if dim != 0 or node.kwargs.get("alpha", 1) != 1 or len(node.args) > 4:
                return None
            if _shape(index) != (nnz,):
                return None
        elif op == "scatter_add":
            base, dim, index, upd = node.args[:4]
            if dim != 0 or _shape(index) != _shape(upd):
                return None
        else:
            return None
        index = self._index_1d(index, nnz)
        if index is None:
            return None
        out_shape, upd_shape = _shape(node), _shape(upd)
        if out_shape is None or upd_shape is None or out_shape[0] != g.num_nodes:
            return None
        if upd_shape[0] != nnz or upd_shape[1:] != out_shape[1:]:
            return None
        up = _origin(upd)
        weight = None
        gathered = self._gather(up, nnz)
        if gathered is None and _op(up) == "mul" and up.target == aten.mul.Tensor:
            a, b = up.args[:2]
            for gat, other in ((a, b), (b, a)):
                gathered = self._gather(gat, nnz) if isinstance(gat, torch.fx.Node) else None
                if gathered is not None and isinstance(other, torch.fx.Node):
                    weight = _strip_expand(other)
                    break
                gathered = None
        if gathered is None:
            return None
        x, gidx = gathered
        xs = _shape(x)
        if xs[0] != g.num_nodes or tuple(xs[1:]) != tuple(upd_shape[1:]):
            return None
        if weight is None:
            kind = "gs" if len(xs) == 2 else None
        elif len(xs) == 2 and _shape(weight) == (nnz, 1):
            kind = "gws"
        elif len(xs) == 3 and _shape(weight) == (nnz, xs[1], 1):
            kind = "mh"
        else:
            kind = None
        if kind is None:
            return None
        return kind, x, weight, base, _op(base) not in _ZEROS, index, gidx

    def _values(self, nodes, example) -> dict:
        """{node: value} of `nodes` when the traced program runs on
        `example` (the trace's meta holds no data)."""
        vals: dict = {}

        class Record(torch.fx.Interpreter):
            def run_node(self, n):
                out = super().run_node(n)
                if n in nodes:
                    vals[n] = out
                return out

        with torch.no_grad():
            Record(self.gm).run(*example)
        return vals

    def _is(self, value, want: torch.Tensor) -> bool:
        """`value` holds the indices of `want` (a graph's edge array)."""
        return (isinstance(value, torch.Tensor) and value.shape == want.shape
                and torch.equal(value.to(device=want.device, dtype=torch.long), want.long()))

    def _arg_positions(self, nodes) -> set:
        """The argument positions (placeholders, in order) that `nodes`
        depend on."""
        place = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        seen, todo = set(), list(nodes)
        while todo:
            n = todo.pop()
            if n not in seen:
                seen.add(n)
                todo.extend(n.all_input_nodes)
        return {i for i, p in enumerate(place) if p in seen}

    def _fused(self, kind: str, add_base: bool, dtype: torch.dtype) -> Callable:
        g, backend = self.graph, self.backend
        n, nnz = g.num_nodes, g.num_edges

        def fused(x, w, base):
            if kind == "gs":
                out = ops.gather_scatter(g.src, g.dst, x, n, graph=g, backend=backend)
            elif kind == "gws":
                out = ops.gather_weight_scatter(g.src, g.dst, w.reshape(nnz), x, n, graph=g,
                                                backend=backend)
            else:
                out = ops.mh_spmm(g.src, g.dst, w.reshape(nnz, x.shape[1]), x, n, graph=g,
                                  backend=backend)
            out = out.to(dtype)
            return out + base.to(dtype) if add_base else out

        fused.__name__ = f"geot_fused_{kind}"
        return fused

    def run(self, example) -> torch.fx.GraphModule:
        """Rewrite the matches whose indices are the graph's (their values
        on `example`); `self.guarded`: the argument positions those indices
        come from."""
        fx_graph = self.gm.graph
        cands = [(node, m) for node in list(fx_graph.nodes)
                 if (m := self.match(node)) is not None]
        vals = self._values({i for _, m in cands for i in m[5:]}, example) if cands else {}
        cands = [(node, m) for node, m in cands
                 if self._is(vals[m[5]], self.graph.dst) and self._is(vals[m[6]], self.graph.src)]
        self.guarded = self._arg_positions([i for _, m in cands for i in m[5:]])
        for node, m in cands:
            kind, x, w, base, add_base = m[:5]
            with fx_graph.inserting_before(node):
                new = fx_graph.call_function(
                    self._fused(kind, add_base, node.meta["val"].dtype),
                    (x, w, base if add_base else None))
            new.meta = dict(node.meta)
            node.replace_all_uses_with(new)
            fx_graph.erase_node(node)
            self.matches += 1
        fx_graph.eliminate_dead_code()
        fx_graph.lint()
        self.gm.recompile()
        return self.gm


def _trace(fn, args, graph: Graph, backend: str):
    """(rewritten module, sites rewritten); the module's `index_guards`
    hold, per argument an accepted index comes from, (position, the traced
    tensor, its version, a copy of its values)."""
    flat, spec = pytree.tree_flatten(args)

    def flat_fn(*leaves):
        return fn(*pytree.tree_unflatten(list(leaves), spec))

    example = [a.detach() if isinstance(a, torch.Tensor) else a for a in flat]
    gm = make_fx(torch.func.functionalize(flat_fn), tracing_mode="real")(*example)
    rw = _Rewriter(gm, graph, backend)
    gm = rw.run(example)
    gm.index_guards = tuple((i, flat[i], flat[i]._version, example[i].clone())
                            for i in sorted(rw.guarded) if isinstance(flat[i], torch.Tensor))
    return gm, rw.matches


def _guards_hold(gm, flat) -> bool:
    """The index arguments of `gm`'s rewrites are the traced tensors,
    unchanged, or hold the same values."""
    return all((flat[i] is obj and obj._version == ver) or torch.equal(flat[i].detach(), vals)
               for i, obj, ver, vals in gm.index_guards)


def _key(flat) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
                 else ("value", a) for a in flat)


def pattern_transform(fn, graph: Graph, *, backend: str = "auto"):
    """`fn` with every matched gather -> (mul) -> scatter-add run through
    the port's fused ops over `graph` (module docstring). The first call
    with new argument shapes traces and rewrites; later calls with those
    shapes run the cached `GraphModule` (`wrapped.cache`: {key: (module,
    sites rewritten)}) unless an index argument of a rewrite changed."""
    cache: dict = {}

    def wrapped(*args):
        flat, spec = pytree.tree_flatten(args)
        key = (spec, _key(flat))
        if key not in cache or not _guards_hold(cache[key][0], flat):
            cache[key] = _trace(fn, args, graph, backend)
        return cache[key][0](*flat)

    wrapped.cache = cache
    return wrapped


def count_matches(fn, graph: Graph, *example_args, backend: str = "auto") -> int:
    """How many scatter-adds the pass rewrites for these example arguments
    (the reference prints the rewritten FX code, `test/compile/test_gcn.py:30`)."""
    return _trace(fn, example_args, graph, backend)[1]
