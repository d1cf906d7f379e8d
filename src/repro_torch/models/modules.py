"""Parameter-definition module system (PyTorch port of
``repro.models.modules``).

Models are pure functions over parameter trees: nested dicts (and lists)
of tensors. Model code declares parameters as ``ParamSpec`` leaves in the
same nesting; the declaration drives
  * real initialization (``init_params``),
  * abstract trees for the dry run (``abstract_params``): meta tensors, or
    DTensors over meta local shards on a mesh, so nothing is allocated,
  * DTensor placements via logical-axis rules (parallel/sharding.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import kernels

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | embed | small
    dtype: Any = torch.float32
    init_scale: float | None = None  # overrides the default fan-in scaling

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (
            f"shape {self.shape} vs axes {self.logical_axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_leaves(tree: PyTree, is_leaf: Callable = is_spec) -> list:
    """Leaves in the reference's flatten order: dict keys sorted, lists in
    order, ``None`` dropped."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: PyTree, is_leaf: Callable = is_spec):
    """``fn`` on every leaf, in ``tree_leaves`` order, keeping the dict/list
    nesting."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return None if tree is None else fn(tree)


# f32 values drawn at once for a leaf stored in another dtype (1 GiB)
_DRAW_VALUES = 1 << 28


def _init_one(spec: ParamSpec, generator: torch.Generator | None,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if generator is None:
        raise ValueError(f"init {spec.init!r} draws random numbers: pass a "
                         "torch.Generator")

    def normal(scale):
        # scaled in place: a large f32 leaf (deepseek-v2-lite's stacked
        # expert weights, 26 x 64 x 2048 x 1408 values each) is never
        # held twice
        if spec.dtype == torch.float32:
            return torch.randn(spec.shape, generator=generator,
                               dtype=torch.float32, device=device
                               ).mul_(scale)
        # a leaf stored in another dtype is drawn in f32 slices along its
        # leading axes, at most _DRAW_VALUES values at a time, and cast
        # into place: llama4's stacked experts (128 x 5120 x 8192 bf16
        # values a leaf) would need a 21 GB f32 temporary drawn whole
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        rows = out.view(-1, spec.shape[-1])
        step = max(1, _DRAW_VALUES // rows.shape[1])
        for i in range(0, rows.shape[0], step):
            part = rows[i:i + step]
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device
                                   ).mul_(scale))
        return out

    if spec.init == "embed":
        return normal(spec.init_scale if spec.init_scale is not None else 1.0)
    # fan-in scaled normal (truncated-normal-ish via plain normal is fine here)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    if len(spec.shape) >= 3:  # stacked layers / experts: fan-in is the 2nd-to-last dim
        fan_in = spec.shape[-2]
    scale = spec.init_scale if spec.init_scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "small":
        scale = 0.02
    return normal(scale)


def init_params(defs: PyTree, generator: torch.Generator | None,
                device) -> PyTree:
    """Materialize a parameter tree from ParamSpec declarations on
    ``device``. Same init kinds and scales as the reference; the numbers
    differ (``jax.random`` vs ``torch.Generator``), so tests that need the
    reference's weights carry them over with ``models.bridge``.
    ``generator`` lives on ``device``; it may be ``None`` when every leaf is
    zeros or ones (caches, batches). Leaves draw in the reference's flatten
    order."""
    device = torch.device(device)
    return tree_map(lambda s: _init_one(s, generator, device), defs)


def abstract_params(defs: PyTree, shardings: PyTree | None = None) -> PyTree:
    """The tree of ``defs`` with nothing allocated: meta tensors of each
    spec's shape and dtype; with ``shardings`` (a tree of
    ``parallel.sharding.Sharding`` alike in nesting,
    ``parallel.sharding.param_shardings``), DTensors on its mesh whose
    local shards are meta tensors of the local shape (rank 0's)."""
    if shardings is None:
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"), defs)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(s, sh):
        local, _ = compute_local_shape_and_global_offset(
            s.shape, sh.mesh, sh.placements)
        return kernels.from_local(
            torch.empty(local, dtype=s.dtype, device="meta"), sh.mesh,
            sh.placements, s.shape)

    specs = tree_leaves(defs)
    shs = tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "placements"))
    if len(specs) != len(shs):
        raise ValueError(f"{len(specs)} specs but {len(shs)} shardings")
    pairs = iter(zip(specs, shs))
    return tree_map(lambda _: one(*next(pairs)), defs)


def param_count(defs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(defs))


def param_bytes(defs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in tree_leaves(defs))


def stack_specs(defs: PyTree, n: int, axis_name: str = "layers") -> PyTree:
    """Add a leading stacked-layers dim to every spec (layers run in a
    loop over that dim)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.logical_axes,
                            s.init, s.dtype, s.init_scale), defs)


# ---------------------------------------------------------------------------
# Sharder: threads (mesh, rules) through model code for activation constraints
# ---------------------------------------------------------------------------

class Sharder:
    """Applies logical-axis sharding constraints to activations.

    On a DTensor, ``sh(x, *axes)`` redistributes ``x`` to the placements
    that the rules give its logical axes on the mesh (the counterpart of
    ``jax.lax.with_sharding_constraint``); on a plain tensor, or with
    ``mesh=None`` (one device), it returns ``x``, so model code can
    unconditionally annotate.
    """

    def __init__(self, mesh=None, rules: dict[str, Any] | None = None):
        self.mesh = mesh
        self.rules = rules or {}

    def __call__(self, x: torch.Tensor, *logical_axes: str | None
                 ) -> torch.Tensor:
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh,
                              self.placements(x.shape, *logical_axes))

    def placements(self, shape, *logical_axes: str | None) -> tuple:
        """The placements the rules give ``logical_axes`` of a tensor of
        ``shape`` on the mesh."""
        from repro_torch.parallel.sharding import (logical_to_placements,
                                                   logical_to_spec)
        spec = logical_to_spec(shape, logical_axes, self.mesh, self.rules)
        return logical_to_placements(spec, self.mesh)

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for x [..., k] and a weight w [k, n]; on a mesh, with
        the layouts of ``einsum``."""
        if not self._on_mesh(x, w):
            return x @ w
        lx = "".join(chr(ord("a") + i) for i in range(x.dim()))
        return _product(f"{lx},{lx[-1]}z->{lx[:-1]}z", x, w,
                        self._fsdp_dims())

    def einsum(self, spec: str, x: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
        """``torch.einsum(spec, x, w)`` of an activation x and a weight w
        (no ellipsis). On a mesh the layouts are stated, not left to
        DTensor's per-operation strategy (which changes between releases):
        w is gathered over the FSDP axes to its compute layout, keeping
        its tensor-parallel splits; x takes w's split where they share a
        dim, is replicated where w splits a dim of its own, and keeps its
        other splits; the product runs on the local shards. Its result is
        split as its operands are, and a partial sum over a mesh dim where
        the contracted dim is split (reduced by the next ``sh``). A
        microbatch whose rows leave FSDP axes idle is split over them
        (``_layout``). Under grad the backward's two products are laid
        out on their own and their results go to the operands' layouts
        (``_GradProduct``), as GSPMD does."""
        if not self._on_mesh(x, w):
            return torch.einsum(spec, x, w)
        return _product(spec, x, w, self._fsdp_dims())

    def lookup(self, table: torch.Tensor, ids: torch.Tensor, dtype
               ) -> torch.Tensor:
        """``table[ids]`` in ``dtype``. On a mesh the table is not gathered:
        the ids are gathered over its splits, each device looks them up in
        its rows (0 for an id outside them) and columns, and the result is
        split as the columns and a partial sum over the row split, which
        the next ``sh`` reduces; the table's gradient is then whole on
        each device's shard, with nothing to reduce."""
        if not self._on_mesh(table, ids):
            return table[ids].to(dtype)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        mesh = self.mesh
        ip = [Replicate() if t.is_shard() or not p.is_shard() else p
              for t, p in zip(table.placements, ids.placements)]
        local = table.to_local()
        _, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        n = local.shape[0]
        t = ids.redistribute(mesh, ip).to_local().long() - offset[0]
        inside = (t >= 0) & (t < n)
        rows = local[t.clamp(0, n - 1)].to(dtype)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return kernels.from_local(rows, mesh, [
            Partial() if p.is_shard(0) else Shard(ids.dim()) if p.is_shard()
            else q for p, q in zip(table.placements, ip)],
            (*ids.shape, table.shape[1]))

    def _on_mesh(self, *ts) -> bool:
        return self.mesh is not None and all(isinstance(t, DTensor)
                                             for t in ts)

    def _fsdp_dims(self) -> set[int]:
        from repro_torch.parallel.sharding import resolve_axes
        names = list(self.mesh.mesh_dim_names)
        return {names.index(a) for a in resolve_axes(self.mesh)["fsdp"]}


class _Gather(torch.autograd.Function):
    """A DTensor laid out by new placements, one mesh dim at a time from
    the last (a dim split over two mesh dims is gathered minor first); the
    gradient goes back one mesh dim at a time from the first, so that a
    gradient partial over both is reduce-scattered over the major dim,
    then the minor one reduces half of it, where DTensor's one-step plan
    all-reduces it whole over one of them."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = t.placements
        return _stepwise(t, placements, reversed(range(t.device_mesh.ndim)))

    @staticmethod
    def backward(ctx, g):
        return _stepwise(g, ctx.placements, range(g.device_mesh.ndim)), None


def _stepwise(t: DTensor, placements, dims) -> DTensor:
    cur = list(t.placements)
    for m in dims:
        if cur[m] != placements[m]:
            cur[m] = placements[m]
            t = t.redistribute(t.device_mesh, cur)
    return t


def _redistributed(t: DTensor, placements) -> DTensor:
    placements = tuple(placements)
    return t if placements == tuple(t.placements) else _Gather.apply(
        t, placements)


_recompute = threading.local()      # .depth: recomputed bodies running


@contextlib.contextmanager
def recomputed():
    """Marks code that its backward recomputes (a body under
    ``torch.utils.checkpoint``): a product there keeps the weight its
    recompute gathers for the backward, which elsewhere gathers the
    weight again (``_GradProduct``)."""
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


def _layout(lx: str, lw: str, out: str, xpl, wpl, size: dict, mesh,
            gather: set[int], grad: bool, keep: bool = True):
    """The layout of the product ``lx,lw->out`` of operands laid out as
    ``xpl`` and ``wpl``: for each mesh dim, [the dim of x split there, the
    dim of w] (None: whole), as ``Sharder.einsum`` states them. On a mesh
    dim of ``gather`` w is gathered, unless x is whole on every mesh dim
    that splits w's dim there and x has that dim: then x takes w's split
    and the product's contraction is split, as GSPMD contracts a
    microbatch whose rows leave the FSDP axes idle. Under grad, a mesh dim
    where neither is split then splits a token dim of x (in x and the
    result, not in w) if the result is a partial sum over a mesh dim of
    its size: GSPMD reduces such a sum over half the tokens and moves them
    where the next layout puts them."""
    def whole(m):
        return xpl[m].is_replicate()

    kept = {m for m in gather if keep and wpl[m].is_shard()
            and lw[wpl[m].dim] in lx
            and all(q in gather and whole(q) for q, p in enumerate(wpl)
                    if p == wpl[m])}
    ways = dict.fromkeys(size, 1)             # mesh ways splitting a dim
    plan = []
    for m, (px, pw) in enumerate(zip(xpl, wpl)):
        a = lx[px.dim] if px.is_shard() else None
        b = lw[pw.dim] if pw.is_shard() else None
        if m in gather and m not in kept:
            b = None                          # w gathered (FSDP)
        if b is not None and a != b:
            a = b if b in lx else None        # x takes w's split, or none
        elif a is not None and b is None and a in lw:
            b = a                             # w sliced to x's split
        if a is not None and a not in out and b is None:
            a = None                          # x's contracted dim: gathered
        if a is None and b is None and not grad:
            # serving, neither split here (decode's few rows on a weight
            # that the tensor-parallel rules leave whole): the contracted
            # dim is split and the product reduced, as GSPMD divides it,
            # rather than repeated on every device
            a = b = next((c for c in lx if c in lw and c not in out
                          and size[c] % (ways[c] * mesh.size(m)) == 0),
                         None)
        for c in {a, b} - {None}:
            ways[c] *= mesh.size(m)
        plan.append([a, b])
    partial = {mesh.size(m) for m, (a, b) in enumerate(plan)
               if (a or b) and (a or b) not in out}
    for m, ab in enumerate(plan):
        if grad and ab == [None, None] and mesh.size(m) in partial:
            t = next((c for c in lx if c in out and c not in lw
                      and size[c] % (ways[c] * mesh.size(m)) == 0), None)
            if t:
                ab[0] = t
                return plan, m
    return plan, None


def _placements(plan, lx: str, lw: str, out: str) -> tuple[list, ...]:
    """-> the placements of x, w and the result of a ``_layout``, and of
    w's gradient at that layout (a partial sum where x alone is
    split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    xp, wp, yp, gw = [], [], [], []
    for a, b in plan:
        xp.append(Shard(lx.index(a)) if a else Replicate())
        wp.append(Shard(lw.index(b)) if b else Replicate())
        s = a or b
        yp.append(Shard(out.index(s)) if s and s in out
                  else Partial() if s else Replicate())
        gw.append(Partial() if a and not b else wp[-1])
    return xp, wp, yp, gw


def _product(spec: str, x: DTensor, w: DTensor,
             gather: set[int]) -> DTensor:
    """``torch.einsum(spec)`` of DTensors x and w on their local shards,
    laid out as ``_layout`` says; ``gather``: the mesh dims w is gathered
    over. Under grad the backward's products are laid out on their own
    (``_GradProduct``)."""
    ins, out = spec.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    size = dict(zip(lx, x.shape)) | dict(zip(lw, w.shape))
    grad = torch.is_grad_enabled()
    plan, tokens = _layout(lx, lw, out, x.placements, w.placements, size,
                           w.device_mesh, gather, grad)
    layout = (lx, lw, out, gather, plan, tokens, x.placements)
    if not grad:
        return _forward(x, w, layout)
    with torch.no_grad():
        # x at the forward's layout but its token split, kept for w's
        # gradient; in a recomputed body w gathered too
        xb = _relaid(x, _placements(_untokened(plan, tokens), lx, lw,
                                    out)[0])
        wg = _relaid(w, _placements(plan, lx, lw, out)[1]) \
            if getattr(_recompute, "depth", 0) else None
    xo, wo = _Operands.apply(x, w, xb, wg)
    return _GradProduct.apply(xo, wo, xb, wg, xo.grad_fn, layout)


def _untokened(plan, tokens) -> list:
    """``plan`` without its token split."""
    return [[None, b] if m == tokens else [a, b]
            for m, (a, b) in enumerate(plan)]


def _forward(x: DTensor, w: DTensor, layout: tuple, wg=None) -> DTensor:
    """The product of x and w that ``layout`` (``_product``'s) describes
    (``wg``: w already gathered to its layout), no autograd. Its sums
    over the splits w keeps on the FSDP axes, and all its sums where its
    tokens are split, are reduced at once."""
    from torch.distributed.tensor import Replicate
    lx, lw, out, gather, plan, tokens, _ = layout
    xp, wp, yp, _ = _placements(plan, lx, lw, out)
    y = _local_einsum(f"{lx},{lw}->{out}", x, xp, w if wg is None else wg,
                      wp, yp)
    return _relaid(y, [Replicate() if p.is_partial() and (
        tokens is not None or m in gather and plan[m][1]) else p
        for m, p in enumerate(yp)])


def _local_einsum(spec: str, a: DTensor, ap, b: DTensor, bp, yp) -> DTensor:
    """``torch.einsum(spec)`` of a laid out as ``ap`` and b as ``bp`` on
    their local shards, as a DTensor laid out as ``yp``; no autograd."""
    ins, out = spec.split("->")
    la, lb = ins.split(",")
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    mesh = a.device_mesh
    al, bl = _relaid(a, ap).to_local(), _relaid(b, bp).to_local()
    return kernels.from_local(torch.einsum(spec, al, bl), mesh, yp,
                              [size[c] for c in out])


def _relaid(t: DTensor, placements) -> DTensor:
    """t laid out as ``placements``, moving as little as it can: first
    the partial sums (one all-reduce over the mesh dims where they are to
    be whole, or split on a dim another mesh dim splits; a
    reduce-scatter where they are to be split alone), then the new
    splits that slice locally, then the old splits gathered from the
    last mesh dim, then the other new splits sliced from the first."""
    from torch.distributed.tensor import Replicate
    cur, mesh = list(t.placements), t.device_mesh

    def alone(m, p):                          # slicing p on m is local
        return all(n < m and placements[n] == p for n, q in enumerate(cur)
                   if q == p and n != m) and all(
            cur[n] == p for n in range(m) if placements[n] == p)
    summed = [m for m, p in enumerate(placements) if cur[m].is_partial()
              and not p.is_partial() and (p.is_replicate() or any(
                  q == p for n, q in enumerate(cur) if n != m))]
    if summed:
        t = _all_reduced(t, summed)
        cur = list(t.placements)
    for m, p in enumerate(placements):
        if cur[m].is_partial() and not p.is_partial():
            cur[m] = p
            t = t.redistribute(mesh, cur)
    for m, p in enumerate(placements):
        if cur[m].is_replicate() and p.is_shard() and alone(m, p):
            cur[m] = p
            t = t.redistribute(mesh, cur)
    for m in reversed(range(mesh.ndim)):
        if cur[m].is_shard() and cur[m] != placements[m]:
            cur[m] = Replicate()
            t = t.redistribute(mesh, cur)
    return _stepwise(t, placements, range(mesh.ndim))


def _all_reduced(t: DTensor, dims: list[int]) -> DTensor:
    """t's partial sums over the mesh dims ``dims`` summed by one
    all-reduce over their devices (``_group``), as GSPMD sums a product
    split over several mesh axes; ``Replicate`` there."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    if len(dims) == 1:
        return t.redistribute(mesh, [Replicate() if m in dims else p
                                     for m, p in enumerate(t.placements)])
    local = funcol.wait_tensor(funcol.all_reduce(
        t.to_local(), "sum", _group(mesh, tuple(dims))))
    return kernels.from_local(local, mesh, [
        Replicate() if m in dims else p for m, p in enumerate(t.placements)],
        t.shape)


def _group(mesh, dims: tuple[int, ...]):
    """The process group of this rank's devices along ``mesh``'s dims
    ``dims``, made once a mesh (every rank makes every such group, in
    the same order). Not a flattened ``DeviceMesh``: DTensor would then
    move every later tensor split over those dims in one collective, and
    the counts of a step would depend on the steps before it."""
    import torch.distributed as dist
    groups = mesh.__dict__.setdefault("_sum_groups", {})
    if dims not in groups:
        rest = [m for m in range(mesh.ndim) if m not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.size(m) for m in dims))
        groups[dims], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[dims]


class _Operands(torch.autograd.Function):
    """x and w of a ``_GradProduct``, passed on unchanged; the node keeps
    what the product's backward needs (x laid out for it, w, and in a
    recomputed body w gathered), so that a recompute under
    ``torch.utils.checkpoint`` that needs no more than these stops before
    the product, as it stops before a local matmul."""

    @staticmethod
    def forward(ctx, x, w, xb, wg):
        ctx.save_for_backward(xb, w, wg)
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        return gx, gw, None, None


class _GradProduct(torch.autograd.Function):
    """A product under grad. GSPMD partitions each product of the step on
    its own, the backward's too, and so does this: the forward as
    ``_layout`` says (``_forward``); x's gradient (``out,w->x``, the
    output gradient laid out as the forward's result was before its
    token split) keeps w's split where the forward kept it or where one
    mesh dim alone splits w's dim and the output gradient is whole
    there, and splits its tokens by the forward's rule; w's gradient is
    computed at the forward's layout without its token split, in w's own
    split on the mesh dims where w was gathered and neither x nor the
    result is split. Each gradient goes to its operand's layout
    (``_relaid``): a gathered weight's gradient is reduce-scattered over
    the FSDP axes, as GSPMD does. Outside a recomputed body the backward
    gathers w again, as the compiled step does; inside one it uses the
    recompute's."""

    @staticmethod
    def forward(ctx, x, w, xb, wg, src, layout):
        ctx.src, ctx.layout = src, layout
        return _forward(xb, w, layout, wg)

    @staticmethod
    def backward(ctx, gy):
        from torch.distributed.tensor import Replicate, Shard
        x, w, wg = ctx.src.saved_tensors       # x at the layout of base
        lx, lw, out, gather, plan, tokens, xpl = ctx.layout
        size = dict(zip(lx, x.shape)) | dict(zip(lw, w.shape))
        base = _untokened(plan, tokens)
        xp, wp, yp, gw = _placements(base, lx, lw, out)
        gp = [Replicate() if p.is_partial() else p for p in yp]
        pw = w.placements
        dx = dw = None
        if ctx.needs_input_grad[0]:
            kept = {m for m in gather if pw[m].is_shard() and (
                wp[m] == pw[m]
                or gp[m].is_replicate() and pw.count(pw[m]) == 1)}
            dplan, _ = _layout(out, lw, lx, gp, pw, size, w.device_mesh,
                               gather - kept, True, keep=False)
            gp2, wp2, dxp, _ = _placements(dplan, out, lw, lx)
            if wg is not None and tuple(wg.placements) == tuple(wp2):
                w = wg
            dx = _relaid(_local_einsum(f"{out},{lw}->{lx}", gy, gp2, w, wp2,
                                       dxp), xpl)
        if ctx.needs_input_grad[1]:
            idle = {m for m in gather if gw[m].is_replicate()
                    and xp[m].is_replicate() and gp[m].is_replicate()}
            for m in gather:
                if pw[m].is_shard() and lw[pw[m].dim] not in lx and all(
                        q in idle for q, p in enumerate(pw) if p == pw[m]):
                    gw[m] = pw[m]             # the result sliced to it
                    gp[m] = Shard(out.index(lw[pw[m].dim]))
            dw = _relaid(_local_einsum(f"{lx},{out}->{lw}", x, xp, gy, gp,
                                       gw), pw)
        return dx, dw, None, None, None, None


# ---------------------------------------------------------------------------
# Common NN pieces (pure functions; params passed explicitly)
# ---------------------------------------------------------------------------

def at_use(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A weight w over x's last dim (a norm's scale or bias) laid out as
    x is, whatever x's layout: on a mesh, split where x's last dim is
    split and whole elsewhere, its FSDP split gathered at use as GSPMD
    gathers it. Where x is whole on batch axes its rows leave idle (a
    microbatch with fewer rows than they have devices) the norm keeps it
    whole there, and the next product splits it as the compiled step
    does (``_layout``); left to DTensor, a multiply would split x's last
    dim to match w instead. Plain tensors: w."""
    if not (isinstance(w, DTensor) and isinstance(x, DTensor)):
        return w
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    return _redistributed(w, [Shard(0) if p.is_shard(last) else Replicate()
                              for p in x.placements])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    scale = at_use(scale, x)
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt)       # back to x's dtype, then scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    scale, bias = at_use(scale, x), at_use(bias, x)
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_defs(kind: str, d: int) -> PyTree:
    if kind == "rms":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def apply_norm(kind: str, p: PyTree, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p["bias"], eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu(approximate=True)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def residual(cfg, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A sublayer's residual add: x + out, with out times
    ``cfg.residual_multiplier`` in the same add where that is not 1."""
    r = cfg.residual_multiplier
    return x + out if r == 1 else torch.add(x, out, alpha=r)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] for each row: logsumexp less the label's
    logit. logits [..., V] f32; labels int [...]. Logits that are a
    DTensor split on the vocabulary are reduced without gathering it
    (``_vocab_parallel_nll``)."""
    if isinstance(logits, DTensor) and any(
            p.is_shard(logits.dim() - 1) for p in logits.placements):
        return _vocab_parallel_nll(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


def _vocab_parallel_nll(logits: DTensor, labels: DTensor) -> DTensor:
    """``token_nll`` of logits split on the vocabulary, as GSPMD evaluates
    it: each device takes its shard's max and sum of exponentials and its
    label logits (a masked local gather: a label outside the shard gives
    0), and one all-reduce over the vocabulary's mesh dims combines each
    (max, then sum). The rows keep their splits; the labels are laid out
    as the rows."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, v = logits.device_mesh, logits.dim() - 1
    rows = [Replicate() if p.is_shard(v) or p.is_partial() else p
            for p in logits.placements]
    logits = logits.redistribute(mesh, [
        p if p.is_shard(v) else r for p, r in zip(logits.placements, rows)])
    split = [p.is_shard(v) for p in logits.placements]
    shape = logits.shape[:-1]

    def reduced(t, op):
        return kernels.from_local(t, mesh, [
            Partial(op) if s else r for s, r in zip(split, rows)],
            shape).redistribute(mesh, rows)

    local = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    n = local.shape[-1]
    m = reduced(local.detach().amax(-1), "max").to_local()
    sum_exp = reduced(torch.exp(local - m[..., None]).sum(-1), "sum")
    t = labels.redistribute(mesh, rows).to_local().long() - offset[v]
    inside = (t >= 0) & (t < n)
    ll = torch.gather(local, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    ll = reduced(torch.where(inside, ll, torch.zeros_like(ll)), "sum")
    return kernels.from_local(m, mesh, rows, shape) + torch.log(sum_exp) - ll


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None):
    """Mean next-token CE. logits [..., V] fp-anything; labels int [...]."""
    nll = token_nll(logits.float(), labels)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
