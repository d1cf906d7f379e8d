"""Weights drawn from the seed on the device, in the serving dtype, in a
few large calls: one flat buffer of normal draws, then each leaf a view
of it, scaled in place. The tree is the one the program's parameter
declarations name; the same tensors go to the reference by flat name
("layers.attn.wq")."""
from __future__ import annotations

import math

import torch

# normal values drawn by one call
DRAW_CHUNK = 1 << 30


def flat_specs(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(dotted name, declaration) of every leaf, keys in sorted order."""
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        out = []
        for k in keys:
            out += flat_specs(tree[k], f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def flatten(tree, prefix: str = "") -> dict:
    """{dotted name: leaf} of a tree of tensors."""
    return {n: t for n, t in flat_specs(tree, prefix)}


def scale_of(spec) -> float:
    """The std a leaf is drawn with: its declared scale, 0.02 for a
    "small" leaf, else 1/sqrt(fan-in) (the second-to-last dim)."""
    if spec.init == "small":
        return 0.02
    if spec.init_scale is not None:
        return spec.init_scale
    if spec.init == "embed":
        return 1.0
    fan_in = spec.shape[-2] if len(spec.shape) > 1 else spec.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def draw(defs, seed: int, device, dtype=torch.bfloat16
         ) -> tuple[dict, dict]:
    """-> (the parameter tree, {flat name: the same tensor}). Leaves
    declared "zeros" or "ones" are filled; every other leaf is a normal
    draw times ``scale_of``."""
    specs = flat_specs(defs)
    drawn = [(n, s) for n, s in specs if s.init not in ("zeros", "ones")]
    total = sum(math.prod(s.shape) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, DRAW_CHUNK):
        part = buf[i:i + DRAW_CHUNK]
        torch.randn(part.shape, generator=gen, dtype=dtype, device=device,
                    out=part)
    flat, off = {}, 0
    for name, s in drawn:
        n = math.prod(s.shape)
        flat[name] = buf[off:off + n].view(s.shape).mul_(scale_of(s))
        off += n
    for name, s in specs:
        if s.init in ("zeros", "ones"):
            fill = torch.ones if s.init == "ones" else torch.zeros
            flat[name] = fill(s.shape, dtype=dtype, device=device)
    return _tree(defs, flat), flat


def _tree(defs, flat: dict, prefix: str = ""):
    if isinstance(defs, dict):
        return {k: _tree(defs[k], flat, f"{prefix}{k}.") for k in defs}
    if isinstance(defs, (list, tuple)):
        return type(defs)(_tree(v, flat, f"{prefix}{i}.")
                          for i, v in enumerate(defs))
    return flat[prefix[:-1]]
