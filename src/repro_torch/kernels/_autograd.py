"""Autograd for the hand-written kernels.

A kernel fills its outputs through ctypes, which autograd cannot see. So
each public kernel entry runs through :func:`kernel_call`: when grad is
enabled and an input requires it, the call goes through :class:`Recompute`,
whose forward launches the kernel as before and whose backward computes a
vector-Jacobian product from the saved inputs in plain PyTorch: the
kernel's own (``vjp``, flash_gqa's chunk-by-chunk backward of the model's
algorithm), or by default the plain version recomputed under
``torch.enable_grad()`` and differentiated. Outputs of an integer type
(counts, slots, ids) get no gradient. There is no backward kernel (the
Pallas kernels have none either). Under ``torch.no_grad()`` or
``torch.inference_mode()`` the launch is called directly.
"""
from __future__ import annotations

import torch


class Recompute(torch.autograd.Function):
    """forward: ``launch(*xs)``, a tuple of tensors; backward: ``vjp(xs,
    gouts, need)`` -> the gradient of each input (None where ``need`` is
    False), with ``gouts`` one cotangent an output (None where it has
    none)."""

    @staticmethod
    def forward(ctx, launch, vjp, *xs):
        ctx.vjp = vjp
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs)
        outs = tuple(launch(*xs))
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        need = ctx.needs_input_grad[2:]
        return (None, None, *ctx.vjp(ctx.saved_tensors, gouts, need))


def plain_vjp(plain):
    """The backward of a call whose ``plain(*xs)`` -> the tuple of
    outputs: the plain version recomputed on the saved inputs under
    ``torch.enable_grad()``, and its vector-Jacobian product."""
    def vjp(saved, gouts, need):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
            outs = plain(*xs)
            pairs = [(o, g) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        return [next(grads) if n else None for n in need]
    return vjp


def kernel_call(launch, plain, *xs: torch.Tensor, vjp=None) -> tuple:
    """``launch(*xs)``, differentiable where grad is needed through
    ``vjp`` (``Recompute``'s), by default ``plain_vjp(plain)``. -> the
    tuple of outputs."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return Recompute.apply(launch, vjp or plain_vjp(plain), *xs)
    return tuple(launch(*xs))


class _Select(torch.autograd.Function):
    """forward: ``x.index_select(dim, index)``; backward: the gradient
    rows of a repeated index added in a fixed order. On the CPU that is
    ``index_select``'s own backward, ``index_add_``, which adds them in
    index order. On CUDA ``index_add_`` adds them by float atomics, in the
    order the threads land once there are more than 16 indices, so two
    runs of one train step would differ in the last bits of such a
    gradient; there ``index_put_(accumulate=True)`` sorts the indices and
    adds each run of equal ones in order (as ``relational/ops.py:
    _group_sum`` does, fault F3). On the CPU ``index_put_`` would add in
    an order that depends on the thread count. The meta device (the dry
    run) takes the CUDA path, as it stands in for the card."""

    @staticmethod
    def forward(ctx, x, dim, index):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.save_for_backward(index)
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return add_rows(g, ctx.dim, index, ctx.size), None, None


def add_rows(g: torch.Tensor, dim: int, index: torch.Tensor, size: int
             ) -> torch.Tensor:
    """The gradient of ``x.index_select(dim, index)`` for x of ``size``
    rows along ``dim``: ``g``'s rows added into their indices, in the fixed
    order ``_Select`` describes."""
    if g.device.type not in ("cuda", "meta"):
        shape = list(g.shape)
        shape[dim] = size
        return g.new_zeros(shape).index_add_(dim, index, g)
    g = g.movedim(dim, 0)
    out = g.new_zeros((size,) + g.shape[1:])
    out.index_put_((index.long(),), g, accumulate=True)
    return out.movedim(0, dim)


def index_select(x: torch.Tensor, dim: int, index: torch.Tensor
                 ) -> torch.Tensor:
    """``x.index_select(dim, index)``, differentiable in ``x`` with a
    backward that gives the same bits every run on any device."""
    return _Select.apply(x, dim, index)
