"""Autograd for the hand-written kernels.

A kernel fills its outputs through ctypes, which autograd cannot see. So
each public kernel entry runs through :func:`kernel_call`: when grad is
enabled and an input requires it, the call goes through :class:`Recompute`,
whose forward launches the kernel as before and whose backward recomputes
the kernel's plain PyTorch version on the saved inputs under
``torch.enable_grad()`` and returns that version's vector-Jacobian
product. Outputs of an integer type (counts, slots, ids) get no gradient.
There is no backward kernel (the Pallas kernels have none either). Under
``torch.no_grad()`` or ``torch.inference_mode()`` the launch is called
directly.
"""
from __future__ import annotations

import torch


class Recompute(torch.autograd.Function):
    """forward: ``launch(*xs)``; backward: the VJP of ``plain(*xs)``. Both
    return a tuple of tensors, alike in number, shape and dtype."""

    @staticmethod
    def forward(ctx, launch, plain, *xs):
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs)
        outs = tuple(launch(*xs))
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*xs)
            pairs = [(o, g) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, *[next(grads) if n else None for n in need])


def kernel_call(launch, plain, *xs: torch.Tensor) -> tuple:
    """``launch(*xs)``, differentiable through ``plain`` where grad is
    needed. -> the tuple of outputs."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return Recompute.apply(launch, plain, *xs)
    return tuple(launch(*xs))
