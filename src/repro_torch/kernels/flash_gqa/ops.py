"""Public flash_gqa entry point in model layout: the CUDA kernel for CUDA
tensors, a shape-only launch for meta tensors (the dry run's stand-in for
the card), the plain materialized attention for CPU tensors, nothing else.
All take the same arguments and refuse the same ones (``ValueError``).
DTensors (a mesh's dry run) run the entry on their local shards, after
redistributing q, k and v to a layout that is local to the kernel
(``_on_mesh``). ``work`` is the function's closed-form FLOPs and bytes, the
least it needs (every bound's numerator); ``model_work`` is what a step
analysis counts for a call: the FLOPs of the model's own algorithm, which
the reference's program runs in the kernel's place."""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import kernels
from repro_torch.kernels.flash_gqa import flash_gqa as K
from repro_torch.models.attention import attention_chunks


def work(q_shape, k_shape, v_shape, *, causal: bool = True, window: int = 0,
         elem_bytes: int = 2) -> tuple[int, int]:
    """(flops, bytes) the function needs: q.k (2*D FLOP) and p.v (2*Dv
    FLOP) for every (query, key) pair the masks leave, per (b, h): the
    causal triangle, within the window where there is one (causal and
    window imply Sq == Skv), and all Sq x Skv pairs with no mask; q and o
    (Sq rows) and k and v (Skv rows, at kv-head layout) read or written
    once, and the H-entry int32 head map."""
    B, Sq, H, D = q_shape
    Skv, Hkv, Dv = k_shape[1], k_shape[2], v_shape[3]
    # query i sees keys [lo_i, hi_i): hi_i = i + 1 (causal) or Skv, lo_i =
    # max(0, i - window + 1) with a window, else 0
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    if window > 0:
        n = max(0, Sq - window)
        pairs -= n * (n + 1) // 2
    flops = 2 * (D + Dv) * pairs * B * H
    nbytes = (B * Sq * H * (D + Dv) + B * Skv * Hkv * (D + Dv)) \
        * elem_bytes + 4 * H
    return flops, nbytes


def model_work(q_shape, k_shape, v_shape, *, causal: bool = True,
               window: int = 0, impl: str = "chunked",
               chunk: int | None = None, elem_bytes: int = 2
               ) -> tuple[int, int]:
    """(flops, bytes) a step analysis counts for a call: the FLOPs of the
    model's algorithm at ``impl`` and ``chunk`` (``models/attention.py:
    attention``, the reference's jnp path; ``chunk`` None: one chunk of Sq
    queries), q.k (2*D) and p.v (2*Dv) for every query of each chunk of
    ``attention_chunks``, padded rows included, against all of its keys,
    masked or not; the bytes are ``work``'s, what the kernel moves."""
    B, Sq, H, D = q_shape
    Skv, Dv = k_shape[1], v_shape[3]
    pairs = sum(c * keys for _, _, c, keys in attention_chunks(
        Sq, Skv, impl=impl, causal=causal, window=window,
        chunk=chunk or Sq))
    return 2 * (D + Dv) * pairs * B * H, work(
        q_shape, k_shape, v_shape, causal=causal, window=window,
        elem_bytes=elem_bytes)[1]


def flash_gqa(q, k, v, *, causal: bool = True, window: int = 0,
              kv_head=None, impl: str = "chunked", chunk: int | None = None,
              scale: float | None = None):
    """q [B,Sq,H,D]; k [B,Skv,Hkv,D]; v [B,Skv,Hkv,Dv] (Sq == Skv unless
    neither ``causal`` nor ``window``); ``kv_head`` maps query head h to
    its kv head (host ints; default h // (H / Hkv)); ``impl`` and
    ``chunk``: the model's attention algorithm, which the backward
    differentiates and a step analysis counts (``model_work``); ``scale``:
    the softmax scale (None: 1/sqrt(D)). -> o [B,Sq,H,Dv] in q's dtype."""
    kw = {"causal": causal, "window": window, "kv_head": kv_head,
          "impl": impl, "chunk": chunk, "scale": scale}
    if isinstance(q, DTensor):
        return _on_mesh(q, k, v, **kw)
    if kernels.kernel_route(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        with kernels.entry("flash_gqa", lambda: model_work(
                q.shape, k.shape, v.shape, causal=causal, window=window,
                impl=impl, chunk=chunk, elem_bytes=q.element_size())):
            return K.flash_gqa(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_gqa has no path for {q.device}")
    return K.plain(q, k, v, causal=causal, window=window, kv_head=kv_head,
                   scale=scale)


def _on_mesh(q, k, v, *, causal, window, kv_head, impl, chunk, scale):
    """The call on DTensors: on each mesh dim, q, k and v keep a batch
    split where q has one (k and v take it too), q keeps a head split (k
    and v are gathered whole, and each device maps its own q heads, so
    their gradients are partial sums there); any other layout is gathered
    first. The entry then runs on the local shards, and o has q's
    layout."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    m = K.check_args(q, k, v, window, kv_head, causal)
    mesh = q.device_mesh
    qp, kp = [], []
    for p in q.placements:
        if p == Shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif p == Shard(2):
            qp.append(Shard(2))
            kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kp) for t in (k, v))
    local, offset = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    heads = m[offset[2]:offset[2] + local[2]]
    kg = [Partial() if p == Shard(2) else r for p, r in zip(qp, kp)]
    o = flash_gqa(q.to_local(), k.to_local(grad_placements=kg),
                  v.to_local(grad_placements=kg), causal=causal,
                  window=window, kv_head=heads, impl=impl, chunk=chunk,
                  scale=scale)
    return kernels.from_local(o, mesh, qp, (*q.shape[:3], v.shape[3]))
