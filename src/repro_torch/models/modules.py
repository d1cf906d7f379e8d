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

import dataclasses
import math
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
        from repro_torch.parallel.sharding import (logical_to_placements,
                                                   logical_to_spec)
        spec = logical_to_spec(x.shape, logical_axes, self.mesh, self.rules)
        return x.redistribute(self.mesh,
                              logical_to_placements(spec, self.mesh))


# ---------------------------------------------------------------------------
# Common NN pieces (pure functions; params passed explicitly)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt)       # back to x's dtype, then scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None):
    """Mean next-token CE. logits [..., V] fp-anything; labels int [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
