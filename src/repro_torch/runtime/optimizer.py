"""Optimizers (PyTorch port of ``repro.runtime.optimizer``).

AdamW: f32 moments shaped like the parameter. Adafactor: factored f32
second moments for parameters of ndim >= 2 (a row and a column moment
over the last two dims, so a stacked [L, a, b] leaf keeps [L, a] and
[L, b]), a full second moment for vectors, no first moment, and update
clipping at RMS ``clip_threshold``.

State is declared as ParamSpec trees (``state_defs``), shaped like the
reference's ({"m", "v"} for AdamW, {"f"} for Adafactor), so a checkpoint
can map it leaf for leaf. ``update(grads, state, params, step)`` computes
the reference's arithmetic in f32, in its order, with the bias
corrections and Adafactor's ``beta`` taken from ``t = step + 1`` as an
f32 tensor; it writes the new parameters and moments IN PLACE, under
``torch.no_grad()``, and returns the same trees: a functional update
would hold a second copy of the parameters and state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.modules import ParamSpec, tree_map

PyTree = Any

# AdamW updates a leaf in slices of at most this many values: elementwise,
# so the numbers are those of one pass, while its f32 temporaries stay at
# 256 MiB beside mamba2-2.7b's stacked in_proj (1.7 G values, 6.9 GB)
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    state_defs: Callable[[PyTree], PyTree]  # ParamSpec tree -> ParamSpec tree
    init: Callable[[PyTree], PyTree]            # params -> state
    update: Callable[[PyTree, PyTree, PyTree, torch.Tensor],
                     tuple[PyTree, PyTree]]
    # (grads, state, params, step) -> (params, state), updated in place


def _leafwise(params: PyTree, *trees: PyTree) -> list[tuple]:
    """(parameter, the subtree of each of ``trees`` at its place), for
    every parameter tensor, in the reference's leaf order (dict keys
    sorted): a gradient, a moment, or Adafactor's {"vr", "vc"} / {"v"}."""
    if torch.is_tensor(params):
        return [(params, *trees)]
    keys = range(len(params)) if isinstance(params, list) else sorted(params)
    return [x for k in keys
            for x in _leafwise(params[k], *(t[k] for t in trees))]


def _t(step: torch.Tensor) -> torch.Tensor:
    """The reference's ``(step + 1).astype(f32)``."""
    return (step + 1).to(torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:

    def state_defs(param_defs):
        f32 = lambda s: ParamSpec(s.shape, s.logical_axes, "zeros",
                                  torch.float32)
        return {"m": tree_map(f32, param_defs),
                "v": tree_map(f32, param_defs)}

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return {"m": tree_map(z, params, is_leaf=torch.is_tensor),
                "v": tree_map(z, params, is_leaf=torch.is_tensor)}

    def upd(g, m, v, p, c1, c2):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step_ = (m / c1).div_((v / c2).sqrt_().add_(eps))
        pf = p.float()
        step_.add_(weight_decay * pf)
        p.copy_(pf - lr * step_)

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _t(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        if isinstance(t, DTensor):
            c1, c2 = c1.to_local(), c2.to_local()
        for p, g, m, v in _leafwise(params, grads, state["m"], state["v"]):
            if isinstance(p, DTensor):
                # on a mesh (the dry run): the gradient is reduced to the
                # parameter's layout, and each device updates its shards
                g = g.redistribute(p.device_mesh, p.placements)
                p, g, m, v = (x.to_local() for x in (p, g, m, v))
            slices = [x.view(-1).split(_SLICE) for x in (m, v, p)]
            for gs, ms, vs, ps in zip(g.reshape(-1).split(_SLICE), *slices):
                upd(gs, ms, vs, ps, c1, c2)
        return params, state

    return Optimizer("adamw", state_defs, init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------

def adafactor(lr: float = 1e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:

    def _factored(spec_or_tensor) -> bool:
        return len(spec_or_tensor.shape) >= 2

    def state_defs(param_defs):
        def per(s: ParamSpec):
            if _factored(s):
                return {
                    "vr": ParamSpec(s.shape[:-1], s.logical_axes[:-1],
                                    "zeros", torch.float32),
                    "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                    s.logical_axes[:-2] + s.logical_axes[-1:],
                                    "zeros", torch.float32)}
            return {"v": ParamSpec(s.shape, s.logical_axes, "zeros",
                                   torch.float32)}
        return {"f": tree_map(per, param_defs)}

    def init(params):
        def per(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(per, params, is_leaf=torch.is_tensor)}

    def upd(g, s, p, beta):
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            s["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
            s["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
            vr, vc = s["vr"], s["vc"]
            r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            u = g * torch.rsqrt(r[..., None] * vc[..., None, :] + eps)
        else:
            s["v"].mul_(beta).add_((1 - beta) * g2)
            u = g * torch.rsqrt(s["v"] + eps)
        # update clipping (RMS(u) <= clip_threshold)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(p.float() - lr * u)

    @torch.no_grad()
    def update(grads, state, params, step):
        beta = 1.0 - _t(step) ** (-decay)
        for p, g, s in _leafwise(params, grads, state["f"]):
            upd(g, s, p, beta)
        return params, state

    return Optimizer("adafactor", state_defs, init, update)


def make_optimizer(name: str, lr: float = 1e-4, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
