"""Mixture-of-experts with Starling-style partitioned dispatch (PyTorch port
of ``repro.models.moe``).

The token->expert shuffle is the paper's §3.2 partition-major pack in
tensor form. Each batch row is a dispatch group (GShard grouping): its
S·k entries (token-major, choice-minor) are packed stably by destination
expert into a contiguous [E, C, d] buffer whose offsets are implicit in
the fixed capacity C, and entries past C are dropped (bounded buffers, as
the paper bounds worker memory by tasks per stage).

The pack is ``kernels/partition_pack`` (the hand-written CUDA kernel on a
CUDA device, its plain version on the CPU): one call for the B groups,
with ids b·E + e over B·E partitions. A stable pack of the groups laid end
to end ranks each entry among the entries of its own group and expert
only, so its slots are those of the reference's ``dispatch_indices`` (the
kernel's jnp oracle, ported here as the plain ``dispatch_indices``), drops
included. C follows from the shapes, so nothing is read back to the host.
The pack moves each entry's token number (one int32), not its d_model
row (2048 bf16 values at deepseek-v2-lite's width): the kernel spreads its
work over tiles of 2048 rows, so whole rows would leave the prefill's
12,288 entries to 6 tiles, each copied by one SM. The rows then move once,
in a gather by the packed token numbers, as the reference gathers by
``dispatch_indices``.

The expert FFN is torch einsum, as the reference leaves it to XLA. The
combine reads each entry's expert output back at its slot
(``ops.partition_unpack``: a gather; a dropped entry reads zero, as the
reference's overflow row C does) and sums a token's k weighted entries in
a fixed order. It uses no ``index_add_``, whose float atomics add in no
fixed order on CUDA (fault F3). The shared experts are plain torch.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.kernels._autograd import index_select
from repro_torch.kernels.partition_pack import ops as pp_ops
from repro_torch.models.modules import (ParamSpec, apply_norm, norm_defs,
                                        swiglu)
from repro_torch.obs.spans import count, recording, span, spanned


def moe_defs(cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "ln": norm_defs(cfg.norm_kind, d),
        "router": ParamSpec((d, m.num_experts), ("embed", None), init="small"),
        "w_gate": ParamSpec((m.num_experts, d, m.expert_d_ff),
                            ("moe_e", "moe_d", "moe_f")),
        "w_up": ParamSpec((m.num_experts, d, m.expert_d_ff),
                          ("moe_e", "moe_d", "moe_f")),
        "w_down": ParamSpec((m.num_experts, m.expert_d_ff, d),
                            ("moe_e", "moe_f", "moe_d")),
    }
    if m.num_shared:
        f = m.num_shared * m.expert_d_ff
        defs["shared"] = {
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed"))}
    return defs


def expert_capacity(tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float, align: int = 8) -> int:
    c = int(math.ceil(tokens * top_k / num_experts * capacity_factor))
    return max(align, (c + align - 1) // align * align)


def route(cfg, p, h3):
    """Router on the residual h3 [B,S,d]: the top k of the softmax of the
    f32 logits, renormalized. -> (weights [T,k] f32, experts [T,k] int32,
    the Switch load-balance aux loss)."""
    m = cfg.moe
    B, S, _ = h3.shape
    logits = (h3 @ p["router"].to(h3.dtype)).float()
    logits = logits.reshape(B * S, m.num_experts)
    probs = torch.softmax(logits, dim=-1)                        # [T,E]
    weights, experts = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch): E * mean(frac_tokens_e * mean_prob_e); the
    # one-hot by comparison, which reads nothing back to the host
    one_hot = (experts[:, :1] == torch.arange(
        m.num_experts, device=h3.device)).float()
    frac = one_hot.mean(0)
    mean_prob = probs.mean(0)
    aux = m.num_experts * (frac * mean_prob).sum()
    return weights, experts.to(torch.int32), aux


def dispatch_indices(experts: torch.Tensor, num_experts: int,
                     capacity: int):
    """Starling partition-pack bookkeeping, plain (the reference's jnp
    oracle of the kernel).

    experts [T*k] int32 destination partitions. Returns, int32:
      sort_idx   [T*k] token-slot order, partition-major (the packed layout)
      dest       [T*k] row in the [E*C (+1 overflow)] packed buffer
      keep       [T*k] bool, False for capacity-dropped entries
      offsets    [E]   start row of each partition  (the format's header)
    """
    n = experts.shape[0]
    e = experts.long()
    sort_idx = torch.sort(e, stable=True).indices
    sorted_e = e[sort_idx]
    counts = torch.zeros(num_experts, dtype=torch.long, device=e.device)
    counts.index_put_((e,), torch.ones_like(e), accumulate=True)
    offsets = torch.cumsum(counts, 0) - counts                   # [E]
    pos_in_e = torch.arange(n, device=e.device) - offsets[sorted_e]
    keep = pos_in_e < capacity
    dest = torch.where(keep, sorted_e * capacity + pos_in_e,
                       num_experts * capacity)                  # overflow row
    i32 = torch.int32
    return sort_idx.to(i32), dest.to(i32), keep, offsets.to(i32)


@spanned("model.ffn.dispatch")
def dispatch(h: torch.Tensor, experts: torch.Tensor, num_experts: int,
             capacity: int, sh=None):
    """Pack the entries of h [B,S,d] by expert, per batch row, in one
    ``partition_pack`` call: entry j of row b (token j // k, experts
    [B*S, k]) has id b·E + e. The pack places each entry's token number
    (1-based: the kernel zero-fills empty slots, and row 0 of the gather
    is zeros); the token rows follow in one gather (on a mesh,
    ``_gather_on_mesh`` with ``sh``'s rules).
    -> (buf [B, E, C, d] with empty slots zero, ids [B*S*k] int32, slots
    [B*S*k] int32: an entry's slot within its expert, at or past C where
    it was dropped)."""
    B, S, d = h.shape
    k = experts.shape[-1]
    dev = h.device
    group = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    ids = (experts.reshape(B, S * k) + num_experts * group).reshape(-1)
    token = torch.arange(1, B * S + 1, dtype=torch.int32,
                         device=dev).repeat_interleave(k)[:, None]
    (packed,), _, slots = pp_ops.partition_pack_groups(
        [token], ids, n_parts=B * num_experts, capacity=capacity)
    if isinstance(h, DTensor):
        return _gather_on_mesh(h, packed, num_experts, capacity, sh), ids, \
            slots
    rows = torch.cat([h.new_zeros(1, d), h.reshape(B * S, d)])
    buf = index_select(rows, 0, packed.reshape(-1))
    return buf.view(B, num_experts, capacity, d), ids, slots


def _whole(t, grad=None):
    """A DTensor gathered whole, as a local tensor (``grad``: its
    gradient's placements); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim
                          ).to_local(grad_placements=grad)


def _gather_on_mesh(h: DTensor, packed, E: int, C: int, sh) -> DTensor:
    """The dispatch's gather on a mesh, on each device's shard: the buffer
    [B, E, C, d] is laid out as the expert FFN takes it (batch and
    experts split by ``sh``'s rules); each device gathers the packed
    token numbers of its batch split and experts (the packed table whole:
    one int a slot) from the rows of its batch split, h gathered over the
    other mesh dims. h's gradient is a partial sum over the expert
    split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = h.device_mesh
    B, S, d = h.shape
    shape = (B, E, C, d)
    lay = sh.placements(shape, "batch", "act_experts", None, None)
    hp = [Shard(0) if p.is_shard(0) else Replicate() for p in lay]
    hl = h.redistribute(mesh, hp).to_local(grad_placements=[
        Partial() if p.is_shard(1) else q for p, q in zip(lay, hp)])
    (nb, ne, _, _), (b0, e0, _, _) = compute_local_shape_and_global_offset(
        shape, mesh, lay)
    tok = _whole(packed).view(B, E, C)[b0:b0 + nb, e0:e0 + ne].long()
    rows = torch.cat([hl.new_zeros(1, d), hl.reshape(nb * S, d)])
    buf = rows[torch.where(tok > 0, tok - b0 * S, 0)]
    return kernels.from_local(buf, mesh, lay, shape)


def _combine_on_mesh(eout: DTensor, ids, slots, weights, S: int, k: int
                     ) -> DTensor:
    """The combine of expert outputs eout [B, E, C, d] split on its batch
    and expert dims, on each device's shard: the entries of its batch
    split (their ids b·E + e, slots and router weights, gathered whole:
    a few ints a token) read their rows from its experts (0 from another
    device's), weighted and summed over a token's k in order. -> out
    [B, S, d] split as eout's batch and a partial sum over its expert
    split (reduced by the next ``sh``); the router weights' gradient is a
    partial sum over every mesh dim."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = eout.device_mesh
    B, E, C, d = eout.shape
    eout = eout.redistribute(mesh, [p if p.is_shard(0) or p.is_shard(1)
                                    else Replicate() for p in eout.placements])
    local = eout.to_local()
    (nb, ne, _, _), (b0, e0, _, _) = compute_local_shape_and_global_offset(
        eout.shape, mesh, eout.placements)
    span = slice(b0 * S * k, (b0 + nb) * S * k)
    ids, slots = _whole(ids)[span].long(), _whole(slots)[span].long()
    w = _whole(weights, [Partial()] * mesh.ndim).reshape(-1)[span]
    e = ids % E - e0
    keep = (e >= 0) & (e < ne) & (slots < C)
    rows = local[ids // E - b0, e.clamp(0, ne - 1), slots.clamp(0, C - 1)]
    rows = torch.where(keep[:, None], rows, torch.zeros_like(rows))
    out = (rows * w[:, None]).view(nb, S, k, d).sum(dim=2)
    return kernels.from_local(out, mesh, [
        Partial() if p.is_shard(1) else p for p in eout.placements],
        (B, S, d))


@spanned("model.ffn")
def moe_apply(cfg, p, x, sh):
    """Returns (x + moe_out, aux_loss). While a profiler records, counts
    the entries that got a slot (``moe.kept``) and the slots computed
    (``moe.slots``, B·E·C)."""
    m = cfg.moe
    B, S, d = x.shape
    k = m.top_k
    with span("model.ffn.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    weights, experts, aux = route(cfg, p, h)                     # [T,k]
    C = expert_capacity(S, m.num_experts, k, m.capacity_factor)

    ebuf, ids, slots = dispatch(h, experts, m.num_experts, C, sh)
    if recording():
        count("moe.kept", (slots < C).sum())
        count("moe.slots", B * m.num_experts * C)
    ebuf = sh(ebuf, "batch", "act_experts", None, None)
    g = sh.einsum("becd,edf->becf", ebuf, p["w_gate"].to(h.dtype))
    u = sh.einsum("becd,edf->becf", ebuf, p["w_up"].to(h.dtype))
    with span("model.ffn.act"):
        z = swiglu(g, u)
    z = sh(z, "batch", "act_experts", None, None)
    eout = sh.einsum("becf,efd->becd", z, p["w_down"].to(h.dtype))
    # combine: each entry's row back from its slot (zero where dropped),
    # weighted, then a token's k entries summed in order
    with span("model.ffn.combine"):
        if isinstance(eout, DTensor):
            out = _combine_on_mesh(eout, ids, slots, weights.to(h.dtype), S,
                                   k)
        else:
            back = pp_ops.partition_unpack(
                eout.reshape(B * m.num_experts, C, d), ids, slots,
                C)                                               # [B*S*k,d]
            back = back * weights.reshape(-1, 1).to(h.dtype)
            out = back.view(B, S, k, d).sum(dim=2)

    if m.num_shared:
        sp = p["shared"]
        g = sh.dot(h, sp["w_gate"].to(h.dtype))
        u = sh.dot(h, sp["w_up"].to(h.dtype))
        with span("model.ffn.act"):
            z = swiglu(g, u)
        z = sh(z, "batch", None, "act_mlp")
        out = out + sh.dot(z, sp["w_down"].to(h.dtype))

    return x + sh(out, "batch", "seq", "act_embed"), aux
