"""Mixture-of-experts with Starling-style partitioned dispatch (PyTorch port
of ``repro.models.moe``).

The token->expert shuffle is the paper's §3.2 partition-major pack in
tensor form. Each batch row is a dispatch group (GShard grouping): its
S·k entries (token-major, choice-minor) are packed stably by destination
expert into C slots an expert, offsets implicit in the fixed capacity C,
and entries past C are dropped (bounded buffers, as the paper bounds
worker memory by tasks per stage).

The pack is ``kernels/partition_pack`` (the hand-written CUDA kernel on a
CUDA device, its plain version on the CPU): one call for the B groups over
B·E partitions, an entry's partition its (group, expert) pair. A stable
pack ranks each entry among the entries of its own partition only, so
whatever the partitions' order, its slots are those of the reference's
``dispatch_indices`` (the kernel's jnp oracle, ported here as the plain
``dispatch_indices``), drops included. C follows from the shapes, so
nothing is read back to the host. The pack moves each entry's token
number (one int32), not its d_model row (2048 bf16 values at
deepseek-v2-lite's width): the kernel spreads its work over tiles of 2048
rows, so whole rows would leave the prefill's 12,288 entries to 6 tiles,
each copied by one SM. The rows then move once, in a gather by the packed
token numbers, as the reference gathers by ``dispatch_indices``.

On one device the partition of expert e and group b is e·B + b, so the
packed buffer is expert-major, [E, B, C, d], and nothing permutes it from
the pack to the combine: the gather writes it as [E, B·C, d], the experts
are ``torch.bmm`` of it by [E, d, f] weights, and the combine
(``kernels/moe_combine``: the hand-written CUDA kernel on a CUDA device,
its plain version on the CPU) reads each kept entry's row from the flat
[E·B·C, d] output, weights it and sums a token's k entries in a fixed
order; a dropped entry adds nothing. It uses no ``index_add_``, whose
float atomics add in no fixed order on CUDA (fault F3). On a mesh the
buffer stays batch-major, [B, E, C, d] with partitions b·E + e, laid out
by ``sh``'s rules (batch and experts split); its experts are
``sh.einsum`` and its combine ``_combine_on_mesh``. The shared experts
are plain torch.

The chip's expert share (one device, ``MoEConfig.held_experts``): the
router keeps all ``num_experts`` outputs and its top k, and the capacity
stays the deployment's (``expert_capacity`` over ``num_experts``); only
the entries whose expert is held here are packed, over B x held
partitions (an absent expert's entry gets no slot and is read as a drop),
and only the held experts' weights are here and computed. What goes on to
the next layer is this chip's part of the result, with the shared
experts whole. When every expert is held the path is the one above,
kernel for kernel.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.kernels._autograd import index_select
from repro_torch.kernels.moe_combine.ops import moe_combine as combine
from repro_torch.kernels.partition_pack import ops as pp_ops
from repro_torch.models.modules import (ParamSpec, apply_norm, norm_defs,
                                        residual, swiglu)
from repro_torch.obs.spans import count, recording, span, spanned


def experts_held(m) -> int:
    """The experts whose weights are held here (``MoEConfig.held_experts``,
    0: all ``num_experts``)."""
    return m.held_experts or m.num_experts


def moe_defs(cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    E = experts_held(m)
    defs = {
        "ln": norm_defs(cfg.norm_kind, d),
        "router": ParamSpec((d, m.num_experts), ("embed", None), init="small"),
        "w_gate": ParamSpec((E, d, m.expert_d_ff),
                            ("moe_e", "moe_d", "moe_f")),
        "w_up": ParamSpec((E, d, m.expert_d_ff),
                          ("moe_e", "moe_d", "moe_f")),
        "w_down": ParamSpec((E, m.expert_d_ff, d),
                            ("moe_e", "moe_f", "moe_d")),
    }
    if m.num_shared:
        f = m.shared_d_ff or m.num_shared * m.expert_d_ff
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
             capacity: int, sh=None, first: int = 0,
             n_held: int | None = None):
    """Pack the entries of h [B,S,d] by expert, per batch row, in one
    ``partition_pack`` call: entry j of row b (token j // k, experts
    [B*S, k]) goes to expert e's partition of group b, id e·B + b on one
    device, b·E + e on a mesh. The pack places each entry's token number
    (1-based: the kernel zero-fills empty slots, and row 0 of the gather
    is zeros); the token rows follow in one gather (on a mesh,
    ``_gather_on_mesh`` with ``sh``'s rules). With ``n_held`` below
    ``num_experts`` (one device only) only the experts first .. first +
    n_held - 1 are here: e is counted from ``first``, an entry of another
    expert is not packed, and it comes back with id 0 and slot C, as a
    drop.
    -> (buf with empty slots zero: [E, B*C, d] on one device (E the
    experts held), entry (e, b, slot) at row b·C + slot of expert e, [B,
    E, C, d] on a mesh; ids [B*S*k] int32; slots [B*S*k] int32: an
    entry's slot within its expert, at or past C where it was dropped)."""
    B, S, d = h.shape
    k = experts.shape[-1]
    dev = h.device
    on_mesh = isinstance(h, DTensor)
    n_held = num_experts if n_held is None else n_held
    share = n_held < num_experts
    if share and on_mesh:
        raise ValueError("the expert share runs on one device")
    group = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    e = experts.reshape(B, S * k)
    if share:
        e = e - first
        ids = torch.where((e >= 0) & (e < n_held), e * B + group, -1)
    else:
        ids = e + num_experts * group if on_mesh else e * B + group
    ids = ids.reshape(-1)
    token = torch.arange(1, B * S + 1, dtype=torch.int32,
                         device=dev).repeat_interleave(k)[:, None]
    (packed,), _, slots = pp_ops.partition_pack_groups(
        [token], ids, n_parts=B * n_held, capacity=capacity)
    if on_mesh:
        return _gather_on_mesh(h, packed, num_experts, capacity, sh), ids, \
            slots
    if share:
        # the pack gave an absent expert's entry slot -1
        slots = torch.where(slots < 0, capacity, slots)
        ids = ids.clamp(min=0)
    rows = torch.cat([h.new_zeros(1, d), h.reshape(B * S, d)])
    buf = index_select(rows, 0, packed.reshape(-1))
    return buf.view(n_held, B * capacity, d), ids, slots


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
    """Returns (x + moe_out, aux_loss); the residual add is
    ``modules.residual``. While a profiler records, counts the entries
    that got a slot (``moe.kept``), the slots computed (``moe.slots``,
    B·E·C, E the experts held), on one device the calls that ran the
    expert-major buffer (``moe.expert_major``) and those whose combine
    took the kernel (``moe.combine_kernel``) and, where only a share of
    the experts is held, the routed entries whose expert is held here
    (``moe.local``)."""
    m = cfg.moe
    B, S, _ = x.shape
    k = m.top_k
    E = experts_held(m)
    with span("model.ffn.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    weights, experts, aux = route(cfg, p, h)                     # [T,k]
    C = expert_capacity(S, m.num_experts, k, m.capacity_factor)

    ebuf, ids, slots = dispatch(h, experts, m.num_experts, C, sh,
                                first=m.first_held, n_held=E)
    on_mesh = isinstance(h, DTensor)
    if recording():
        count("moe.kept", (slots < C).sum())
        count("moe.slots", B * E * C)
        if not on_mesh:
            count("moe.expert_major", 1)
            if kernels.kernel_route(h):
                count("moe.combine_kernel", 1)
        if E < m.num_experts:
            count("moe.local", ((experts >= m.first_held)
                                & (experts < m.first_held + E)).sum())
    # the experts on the buffer as dispatch laid it out; the combine: each
    # kept entry's row back from its slot, weighted, then a token's k
    # entries summed in order
    if on_mesh:
        ebuf = sh(ebuf, "batch", "act_experts", None, None)
        g = sh.einsum("becd,edf->becf", ebuf, p["w_gate"].to(h.dtype))
        u = sh.einsum("becd,edf->becf", ebuf, p["w_up"].to(h.dtype))
        with span("model.ffn.act"):
            z = swiglu(g, u)
        z = sh(z, "batch", "act_experts", None, None)
        eout = sh.einsum("becf,efd->becd", z, p["w_down"].to(h.dtype))
        with span("model.ffn.combine"):
            out = _combine_on_mesh(eout, ids, slots, weights.to(h.dtype), S,
                                   k)
    else:
        g = torch.bmm(ebuf, p["w_gate"].to(h.dtype))             # [E,B*C,f]
        u = torch.bmm(ebuf, p["w_up"].to(h.dtype))
        with span("model.ffn.act"):
            z = swiglu(g, u)
        eout = torch.bmm(z, p["w_down"].to(h.dtype))             # [E,B*C,d]
        with span("model.ffn.combine"):
            out = combine(eout, ids, slots, weights.to(h.dtype), C, S, k)

    if m.num_shared:
        sp = p["shared"]
        g = sh.dot(h, sp["w_gate"].to(h.dtype))
        u = sh.dot(h, sp["w_up"].to(h.dtype))
        with span("model.ffn.act"):
            z = swiglu(g, u)
        z = sh(z, "batch", None, "act_mlp")
        out = out + sh.dot(z, sp["w_down"].to(h.dtype))

    return residual(cfg, x, sh(out, "batch", "seq", "act_embed")), aux
