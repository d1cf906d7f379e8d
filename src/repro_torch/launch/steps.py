"""Step builders: train / prefill / decode over a ModelBundle (PyTorch port
of ``repro.launch.steps``).

``make_train_step`` returns (step_fn, state_defs). The state is a dict
{"params", "opt", "step"} shaped like the reference's, whose defs are
ParamSpec trees; ``step_fn(state, batch)`` updates the parameters and the
optimizer state in place (``runtime/optimizer.py``) and returns the state
with ``step`` + 1 and the metrics of the last microbatch.

``prefill_launches`` and ``train_launches`` work out how often a prefill
and a train step of a config launch each hand-written kernel on the card;
``chip_smoke.py`` and the tests hold the counted launches to them.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import (ModelBundle, _llama4_subkinds,
                                      layer_kinds)
from repro_torch.models.modules import (ParamSpec, init_params, tree_leaves,
                                        tree_map)
from repro_torch.obs.spans import span
from repro_torch.runtime.optimizer import Optimizer, make_optimizer


def train_state_defs(bundle: ModelBundle, opt: Optimizer) -> dict:
    return {"params": bundle.param_defs,
            "opt": opt.state_defs(bundle.param_defs),
            "step": ParamSpec((), (), "zeros", torch.int32)}


def init_train_state(bundle: ModelBundle, opt: Optimizer,
                     generator: torch.Generator, device) -> dict:
    """The port's own initialization: parameters drawn from ``generator``
    (on ``device``), zero optimizer state, step 0. Its numbers are not the
    reference's (``jax.random``); parity tests start from bridged weights
    (``models/bridge.py``)."""
    params = init_params(bundle.param_defs, generator, device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=torch.device(device))}


def grads_of(loss_fn, params, batch):
    """-> (the gradient of ``loss_fn(params, batch)[0]`` with respect to
    every leaf of ``params``, as a tree of the same shape in the leaves'
    dtypes; the metrics, detached). The leaves enter the loss as detached
    views that require grad, so the caller's tensors take no part in the
    graph; a leaf the loss does not reach gets zeros. On a mesh each
    gradient leaves in its parameter's layout (the counterpart of the
    reference's pinned ``out_shardings``), so the optimizer moves
    nothing."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params,
                 is_leaf=torch.is_tensor)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, batch)
        leaves = tree_leaves(p, is_leaf=torch.is_tensor)
        gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                      materialize_grads=True))
    grads = tree_map(lambda t: _laid_out_as(next(gs), t), p,
                     is_leaf=torch.is_tensor)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def microbatches(batch: dict, n_mb: int) -> list[dict]:
    """The reference's split of a batch into ``n_mb`` microbatches: a leaf
    whose leading (batch) axis ``n_mb`` divides is cut along it; any other
    leaf goes whole to every microbatch; ``mrope_positions`` [3, B, S] is
    cut along its second axis. -> n_mb batches of views."""
    def split(x):
        if x.dim() and x.shape[0] % n_mb == 0:
            return list(x.reshape((n_mb, x.shape[0] // n_mb) + x.shape[1:]))
        return [x] * n_mb
    parts = {k: ([t.movedim(0, 1) for t in split(v.movedim(0, 1))]
                 if k == "mrope_positions" else split(v))
             for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n_mb)]


def make_train_step(bundle: ModelBundle, opt: Optimizer | None = None):
    opt = opt or make_optimizer(bundle.cfg.optimizer)
    n_mb = max(bundle.cfg.grad_accum, 1)

    def train_step(state: dict, batch: dict):
        if n_mb == 1:
            grads, metrics = grads_of(bundle.loss_fn, state["params"], batch)
        else:
            # gradient accumulation: the microbatches' gradients summed in
            # the parameters' dtype, from zero in microbatch order, then
            # divided by n_mb; the metrics are the last microbatch's
            grads = tree_map(torch.zeros_like, state["params"],
                             is_leaf=torch.is_tensor)
            for mb in microbatches(batch, n_mb):
                g, metrics = grads_of(bundle.loss_fn, state["params"], mb)
                for acc, gi in zip(tree_leaves(grads, torch.is_tensor),
                                   tree_leaves(g, torch.is_tensor)):
                    acc.add_(gi)
                del g
            for acc in tree_leaves(grads, torch.is_tensor):
                acc.div_(n_mb)
        params, opt_state = opt.update(grads, state["opt"], state["params"],
                                       state["step"])
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step, train_state_defs(bundle, opt)


def attention_layers(cfg) -> int:
    """flash_gqa calls of one prefill of ``cfg``: one an attention layer
    (llama4's chunked-local layers make one call over B·S/C chunks),
    griffin's attention layers only (one of each (rec, rec, attn) triple),
    granite-4.0-h's attention layers, and whisper's encoder, decoder self
    and cross attention layers."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid_moe":
        return layer_kinds(cfg).count("attention")
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return cfg.num_layers // len(pat) * pat.count("attn")
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def moe_layers(cfg) -> int:
    """partition_pack calls of one prefill or decode step of ``cfg``, and
    moe_combine calls on one device: one a MoE layer (deepseek-v2: every
    layer after ``first_dense``; llama4: the MoE sub-layers of each
    super-block, every second one; granite-4.0-h: every layer)."""
    if cfg.family == "hybrid_moe":
        return cfg.num_layers
    if cfg.family != "moe":
        return 0
    if cfg.attn_kind == "mla":
        return cfg.num_layers - cfg.moe.first_dense
    kinds = _llama4_subkinds(cfg)
    return cfg.num_layers // len(kinds) * sum(m == "moe" for _, m in kinds)


def mamba_layers(cfg) -> int:
    """ssd_scan calls of one prefill of ``cfg``: one a Mamba layer."""
    if cfg.family == "ssm":
        return cfg.num_layers
    if cfg.family == "hybrid_moe":
        return layer_kinds(cfg).count("mamba")
    return 0


def prefill_launches(cfg) -> dict:
    """The launches of each kernel that one prefill of ``cfg`` makes on
    one device: ssd_scan once a Mamba layer (``mamba_layers``), flash_gqa
    once an attention layer (``attention_layers``), partition_pack (the
    dispatch) and moe_combine once a MoE layer (``moe_layers``)."""
    return {"partition_pack": moe_layers(cfg),
            "moe_combine": moe_layers(cfg),
            "ssd_scan": mamba_layers(cfg),
            "flash_gqa": attention_layers(cfg)}


def train_launches(cfg) -> dict:
    """The launches of each kernel that one train step of ``cfg`` makes
    (``cfg.grad_accum`` microbatches, at least one). Under any ``remat``
    but "none", a kernel in a layer body that remat recomputes launches
    twice a microbatch: in the step's forward and when the backward
    recomputes the body; the backward itself runs the plain versions
    (kernels/_autograd.py) and launches nothing. Outside such a body it
    launches once: deepseek's dense layer 0 runs outside, as in the
    reference. Bodies: a Mamba or decoder layer, deepseek's MoE layers,
    llama4's super-blocks, griffin's triples, whisper's layers,
    granite-4.0-h's layers."""
    n = prefill_launches(cfg)
    if cfg.remat != "none":
        n = {k: 2 * v for k, v in n.items()}
        if cfg.attn_kind == "mla":
            n["flash_gqa"] -= cfg.moe.first_dense
    return {k: v * max(cfg.grad_accum, 1) for k, v in n.items()}


def make_prefill_step(bundle: ModelBundle):
    @torch.inference_mode()
    def prefill_step(params, batch):
        with span("model.prefill"):
            return bundle.prefill_fn(params, batch)
    return prefill_step


def make_decode_step(bundle: ModelBundle):
    @torch.inference_mode()
    def decode_step(params, cache, batch):
        return bundle.decode_fn(params, cache, batch)
    return decode_step
