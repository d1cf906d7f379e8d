"""Logical-axis sharding rules with divisibility fallback (PyTorch port of
``repro.parallel.sharding``).

Model code names tensor dims with logical axes; rules map logical names to
mesh axes. ``logical_to_spec`` validates divisibility and *drops* mesh
axes that do not divide a dim instead of failing, so one rule set serves all
10 assigned architectures (e.g. smollm's 9 heads on a 16-way model axis fall
back to replication).

Default layout = FSDP over ("pod","data") x TP over "model":
  * params: "embed"-like dims sharded over fsdp axes, "mlp"/"heads"/"vocab"
    dims over the model axis, experts over the model axis (EP == TP axis);
  * activations: batch over fsdp axes, heads/mlp over model;
  * long-context KV caches: sequence over fsdp (+ model when batch*heads
    cannot use it).

A spec is a plain tuple with one entry per dim, as ``PartitionSpec`` holds
them: ``None``, a mesh axis name, or a tuple of names (major to minor).
``logical_to_placements`` turns it into DTensor placements on a
``DeviceMesh``: ``Shard(i)`` on every mesh dim named for dim ``i``,
``Replicate()`` elsewhere. DTensor splits a dim sharded over two mesh dims
in mesh-dim order, the earlier mesh dim major, which is JAX's order for
``("pod", "data")`` on the meshes of ``launch/mesh.py`` (their axes are
listed major to minor, as a spec's are).

The rule functions take any mesh object with ``mesh_dim_names`` and a
``shape`` (a ``DeviceMesh``, or a shape-only stand-in in tests).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Sequence

# logical axis -> mesh axis (or tuple of mesh axes). None = replicate.
# "fsdp" and "tp" are resolved against the mesh's actual axis names.
DEFAULT_RULES: dict[str, Any] = {
    # parameter dims
    "embed": "fsdp",           # FSDP shard dim of most weights
    "vocab": "tp",
    "heads_q": "tp",           # fused q-proj out dim (nH*hd)
    "heads_kv": "tp",
    "mlp": "tp",
    "experts": "tp",           # expert-parallel == model axis
    "expert_mlp": None,
    # MoE weight dims (dedicated names so moe_impl can remap them):
    #   gspmd (default): experts@tp, d@fsdp, f unsharded;
    #   a2a: experts@dp, d unsharded, f@tp (weights stationary, tokens move)
    "moe_e": "tp",
    "moe_d": "fsdp",
    "moe_f": None,
    "layers": None,
    "kv_lora": None,
    "conv": None,
    "state": None,
    # activation dims. "seq" is the residual-stream sequence dim, sharded
    # over the model axis (sequence parallelism); internal tensors (q/k/v,
    # mlp hidden) use None for seq and shard their head/mlp dim instead
    "batch": "dp",             # ("pod","data")
    "seq": "tp",
    "act_embed": None,
    "act_heads": "tp",
    "act_mlp": "tp",
    "act_experts": "tp",
    # fallback for archs whose head count does not divide the model axis
    # (llama4: 40H, smollm: 9H): shard attention's q-sequence dim instead.
    # Low priority (see _PRIORITY): heads get first claim on "model".
    "act_seq_q": "tp",
    # MoE dispatch bookkeeping runs on d_model slices so it is tp-local
    "dispatch_embed": "tp",
    # flattened (batch*seq) token dim (router / shared-expert paths)
    "tokens": "dp_tp",
    # kv-cache dims: sequence-sharded KV over the model axis by default
    "cache_batch": "dp",
    "cache_seq": "tp",
    "cache_seq_sharded": "dp_tp",  # long-context: shard cache seq over all axes
    "cache_heads": None,
}


def effective_rules(cfg, rules=None) -> dict:
    """Config-dependent rule overrides (the one source for both
    build_model's activation constraints and the launcher's state
    shardings)."""
    out = dict(rules or {})
    if getattr(cfg, "moe", None) is not None and \
            getattr(cfg, "moe_impl", "") == "a2a":
        out.update({"moe_e": "dp", "moe_d": None, "moe_f": "tp",
                    "act_experts": "dp"})
    return out


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_axes(mesh) -> dict[str, tuple[str, ...]]:
    """Map the abstract fsdp/tp/dp groups onto this mesh's axis names."""
    names = mesh.mesh_dim_names
    tp = ("model",) if "model" in names else ()
    dp = tuple(a for a in names if a in ("pod", "data"))
    return {"fsdp": dp, "tp": tp, "dp": dp, "dp_tp": dp + tp}


def _mesh_axes_for(logical: str | None, rules: Mapping[str, Any],
                   groups: Mapping[str, tuple[str, ...]]) -> tuple[str, ...]:
    if logical is None:
        return ()
    r = rules.get(logical, None)
    if r is None:
        return ()
    if isinstance(r, str):
        return groups.get(r, (r,))
    out: list[str] = []
    for a in r:
        out.extend(groups.get(a, (a,)))
    return tuple(out)


# logical axes with priority > 0 only claim mesh axes left over after the
# default (priority 0) pass — e.g. act_seq_q yields "model" to act_heads.
_PRIORITY: dict[str, int] = {"act_seq_q": 10}


def logical_to_spec(shape: Sequence[int], logical_axes: Sequence[str | None],
                    mesh, rules: Mapping[str, Any] | None = None) -> tuple:
    """The spec of ``shape``, dropping axes that don't divide dims.

    Mesh axes are assigned greedily per dim in priority order (then
    left-to-right); an axis already used by another dim is skipped (a
    spec's axes are unique)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    groups = resolve_axes(mesh)
    sizes = _sizes(mesh)
    used: set[str] = set()
    spec: list[Any] = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: (_PRIORITY.get(logical_axes[i] or "", 0), i))
    for i in order:
        dim, logical = shape[i], logical_axes[i]
        axes = [a for a in _mesh_axes_for(logical, rules, groups)
                if a not in used]
        # greedily keep the prefix of axes whose product divides the dim
        keep: list[str] = []
        prod = 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        if not keep:
            spec[i] = None
        elif len(keep) == 1:
            spec[i] = keep[0]
        else:
            spec[i] = tuple(keep)
    return tuple(spec)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that ``spec[i]`` names, ``Replicate()`` on the rest. A dim
    named over several mesh dims splits in mesh-dim order, which is the
    spec's major-to-minor order when the mesh lists its axes so."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: i for i, entry in enumerate(spec) for a in spec_axes(entry)}
    names = list(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"dim {i} names {axes} against the mesh's "
                             f"order {names}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


class Sharding(NamedTuple):
    """A mesh and the placements of one tensor on it (the counterpart of
    ``NamedSharding``)."""
    mesh: Any
    placements: tuple


def logical_to_sharding(shape, logical_axes, mesh, rules=None) -> Sharding:
    return Sharding(mesh, logical_to_placements(
        logical_to_spec(shape, logical_axes, mesh, rules), mesh))


def param_shardings(defs, mesh, rules=None):
    """Sharding tree (mesh, placements) matching a ParamSpec tree."""
    from repro_torch.models.modules import tree_map
    return tree_map(lambda s: logical_to_sharding(s.shape, s.logical_axes,
                                                  mesh, rules), defs)


def bytes_per_device(defs, mesh, rules=None) -> int:
    """Estimated parameter bytes per device under the rules (for napkin
    math)."""
    from repro_torch.models.modules import tree_leaves
    sizes = _sizes(mesh)
    total = 0
    for spec in tree_leaves(defs):
        p = logical_to_spec(spec.shape, spec.logical_axes, mesh, rules)
        shards = 1
        for entry in p:
            for a in spec_axes(entry):
                shards *= sizes[a]
        total += math.prod(spec.shape) * spec.dtype.itemsize // shards
    return total
