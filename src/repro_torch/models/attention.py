"""Attention flavors for the model zoo (PyTorch port of
``repro.models.attention``).

Everything here is plain PyTorch: the CPU path of the dense decoder's
prefill, and its decode path on every device. On a CUDA device the
prefill's attention goes to the hand-written Hopper kernel instead
(``models/transformer.py`` through ``kernels/flash_gqa/ops.py``), which
computes the same function.

Prefill uses *chunked online-softmax* attention (a loop over query chunks
against the full K with masking), so the [S, S] score matrix is never
materialized at once: memory O(chunk x S) a step. ``causal_split_attention``
skips most of the causal upper triangle by recursion. ``attention_chunks``
lists the chunks ``attention`` computes, and ``attention_vjp`` is its
backward chunk by chunk: the kernel's backward, and what the dry run
counts for a kernel call.

Where the reference asks a product for an f32 result from bf16 operands
(``preferred_element_type=jnp.float32``), the port multiplies the operands
widened to f32: the same exact products, summed in f32, not rounded to
bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x [B,S,H,D], positions [B,S] -> rotated x (first fraction*D dims).
    cos and sin are cast to x's dtype before the multiply, as in the
    reference."""
    D = x.shape[-1]
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0 or theta <= 0:
        return x
    inv = _inv_freq(rot, theta, x.device)                         # [rot/2]
    ang = positions.float()[..., None] * inv                  # [B,S,rot/2]
    cos = torch.cos(ang)[:, :, None, :]                     # [B,S,1,rot/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cat([cos, cos], dim=-1).to(x.dtype)
    sin = torch.cat([sin, sin], dim=-1).to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    xr = xr * cos + _rotate_half(xr) * sin
    return torch.cat([xr, xp], dim=-1) if rot < D else xr


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions [3,B,S] (t/h/w), sections sum to
    D/2."""
    D = x.shape[-1]
    inv = _inv_freq(D, theta, x.device)                           # [D/2]
    assert sum(sections) == D // 2, (sections, D)
    # section id for each frequency index
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=x.device)
                         for i, s in enumerate(sections)])
    pos = positions.float()                                       # [3,B,S]
    # per-freq position: pick the t/h/w stream per section -> [B,S,D/2]
    pos_sel = pos.index_select(0, sec_ids).movedim(0, -1)
    ang = pos_sel * inv
    cos = torch.cat([torch.cos(ang)] * 2, -1)[:, :, None, :].to(x.dtype)
    sin = torch.cat([torch.sin(ang)] * 2, -1)[:, :, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,Hkv,D] -> [B,S,Hkv*n_rep,D]; q head h uses kv head h // n_rep."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _scale(scale: float | None, D: int) -> float:
    """The softmax scale: ``scale``, or 1/sqrt(D) where it is None."""
    return 1.0 / math.sqrt(D) if scale is None else scale


def _scores(q, k, scale):
    """f32 scores [B,H,q,k] of q [B,q,H,D] against k [B,k,H,D]."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset=0,
                      kv_valid_len=None, scale: float | None = None
                      ) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks.

    q [B,Sq,H,D], k/v [B,Skv,H,D(v)] (kv already head-repeated).
    window > 0 limits attention to the last ``window`` positions (inclusive
    of self). q_offset: global position of q[0] relative to k[0].
    kv_valid_len [B]: keys at or past it are masked per batch row.
    scale: the softmax scale (None: 1/sqrt(D)).
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    scale = _scale(scale, D)
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    n = (Sq + pad) // chunk
    outs = []
    for idx in range(n):
        qi = q[:, idx * chunk:(idx + 1) * chunk]              # [B,chunk,H,D]
        p = _chunk_probs(qi, k, q_offset + idx * chunk, scale, causal=causal,
                         window=window, kv_valid_len=kv_valid_len)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq] if pad else out


def _chunk_probs(qi, k, row, scale, *, causal, window, kv_valid_len=None):
    """The f32 softmax probabilities [B,H,c,Skv] of query chunk qi
    [B,c,H,D], whose first query sits at position ``row`` of k [B,Skv,H,D],
    under ``chunked_attention``'s masks."""
    Skv, c = k.shape[1], qi.shape[1]
    kpos = torch.arange(Skv, device=qi.device)
    qpos = row + torch.arange(c, device=qi.device)
    s = _scores(qi, k, scale)
    m = torch.ones((c, Skv), dtype=torch.bool, device=qi.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    if kv_valid_len is not None:
        valid = kpos[None, None, :] < torch.as_tensor(
            kv_valid_len, device=qi.device)[:, None, None]
        s = s.masked_fill(~(m[None] & valid)[:, None], NEG_INF)
    else:
        s = s.masked_fill(~m[None, None], NEG_INF)
    return torch.softmax(s, dim=-1)


def block_tri_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, chunk: int = 1024,
                        q_offset=0) -> torch.Tensor:
    """Causal attention that only computes lower-triangular chunk pairs,
    with an online-softmax accumulator per query chunk (the reference's
    scan over the static list of (qi, ki) pairs, as a loop)."""
    B, Sq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Sq)
    n = Sq // chunk
    assert Sq % chunk == 0 and k.shape[1] == Sq, "block_tri needs Sq == Skv"
    if window > 0:
        # pairs within the window band only
        band = max(1, -(-window // chunk) + 1)
        pairs = [(qi, ki) for qi in range(n)
                 for ki in range(max(0, qi - band + 1), qi + 1)]
    else:
        pairs = [(qi, ki) for qi in range(n) for ki in range(qi + 1)]
    Dv = v.shape[-1]
    dev = q.device
    o = [torch.zeros((B, H, chunk, Dv), dtype=torch.float32, device=dev)
         for _ in range(n)]
    m = [torch.full((B, H, chunk), NEG_INF, dtype=torch.float32, device=dev)
         for _ in range(n)]
    l = [torch.zeros((B, H, chunk), dtype=torch.float32, device=dev)
         for _ in range(n)]
    ar = torch.arange(chunk, device=dev)
    for qi, ki in pairs:
        qb = q[:, qi * chunk:(qi + 1) * chunk]
        kb = k[:, ki * chunk:(ki + 1) * chunk]
        vb = v[:, ki * chunk:(ki + 1) * chunk]
        qpos = q_offset + qi * chunk + ar
        kpos = q_offset + ki * chunk + ar
        s = _scores(qb, kb, scale)
        msk = kpos[None, :] <= qpos[:, None]
        if window > 0:
            msk &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~msk[None, None], NEG_INF)
        m_new = torch.maximum(m[qi], s.amax(dim=-1))               # [B,H,c]
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m[qi] - m_new)
        l[qi] = l[qi] * alpha + p.sum(dim=-1)
        o[qi] = o[qi] * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).float()
        m[qi] = m_new
    out = torch.stack(o) / torch.clamp(torch.stack(l)[..., None], min=1e-30)
    # [n,B,H,c,Dv] -> [B,n,c,H,Dv] -> [B,Sq,H,Dv]
    return out.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, Dv).to(v.dtype)


SPLIT_DEPTH = 3                   # causal_split_attention's recursion


def causal_split_attention(q, k, v, *, chunk=512, q_offset=0,
                           depth=SPLIT_DEPTH, scale=None):
    """Recursive causal decomposition (the triangular skip in plain
    PyTorch): the lower query half attends only to the lower KV half
    (recurse); the upper half attends to everything (plain masked chunked
    attention). Sequences shorter than two chunks take
    ``chunked_attention`` whole."""
    B, S, H, D = q.shape
    if depth <= 0 or S < 2 * chunk or S % 2 or q_offset != 0 \
            or k.shape[1] != S:
        return chunked_attention(q, k, v, causal=True, chunk=chunk,
                                 q_offset=q_offset, scale=scale)
    half = S // 2
    lo = causal_split_attention(q[:, :half], k[:, :half], v[:, :half],
                                chunk=chunk, depth=depth - 1, scale=scale)
    hi = chunked_attention(q[:, half:], k, v, causal=True, chunk=chunk,
                           q_offset=half, scale=scale)
    return torch.cat([lo, hi], dim=1)


def attention(q, k, v, *, impl="chunked", causal=True, window=0, chunk=1024,
              q_offset=0, kv_valid_len=None, scale=None):
    if impl == "block_tri" and causal and kv_valid_len is None \
            and window == 0 and q_offset == 0 and k.shape[1] == q.shape[1]:
        return causal_split_attention(q, k, v, chunk=chunk, scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset,
                             kv_valid_len=kv_valid_len, scale=scale)


def attention_chunks(Sq: int, Skv: int, *, impl="chunked", causal=True,
                     window=0, chunk=1024) -> list[tuple[int, int, int, int]]:
    """The query chunks that ``attention`` (no ``q_offset``, no
    ``kv_valid_len``) computes for Sq queries against Skv keys, in its
    order: (row, rows, padded, keys) for each, the ``rows`` queries from
    ``row`` (zero-padded to ``padded``, as ``chunked_attention`` pads the
    last chunk) against the first ``keys`` keys. The causal split gives
    the lower half's chunks against the lower half's keys (recursively),
    then the upper half's against all keys."""
    def chunked(row, n, keys):
        c = min(chunk, n)
        return [(row + i, min(c, n - i), c, keys) for i in range(0, n, c)]

    def split(S, depth):
        if depth <= 0 or S < 2 * chunk or S % 2:
            return chunked(0, S, S)
        half = S // 2
        return split(half, depth - 1) + chunked(half, half, S)

    if impl == "block_tri" and causal and window == 0 and Skv == Sq:
        return split(Sq, SPLIT_DEPTH)
    return chunked(0, Sq, Skv)


def attention_vjp(q, k, v, go, *, impl="chunked", causal=True, window=0,
                  chunk=1024, scale=None):
    """The gradients (dq, dk, dv) of ``attention(q, k, v, impl=, causal=,
    window=, chunk=)`` under the cotangent ``go`` [B,Sq,H,Dv], k and v at
    q's heads, in the dtypes of q, k and v. It takes the chunks of
    ``attention_chunks`` one by one and recomputes each chunk's
    probabilities from q and k, as the reference's backward recomputes its
    checkpointed chunk (``jax.checkpoint`` of ``one_chunk``), so no score
    matrix outlives its chunk: five products a chunk (the scores, then
    dv = p^T.go, dp = go.v^T, dq = ds.k and dk = ds^T.q with ds = p *
    (dp - rowsum(dp * p))), in the dtypes the forward's products have;
    dq, dk and dv are summed in f32. ``scale``: the forward's softmax scale
    (None: 1/sqrt(D))."""
    B, Sq, H, D = q.shape
    scale = _scale(scale, D)
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    for row, n, c, keys in attention_chunks(Sq, k.shape[1], impl=impl,
                                            causal=causal, window=window,
                                            chunk=chunk):
        qi, gi = q[:, row:row + n], go[:, row:row + n]
        if c > n:
            qi, gi = (F.pad(t, (0, 0, 0, 0, 0, c - n)) for t in (qi, gi))
        kc, vc = k[:, :keys], v[:, :keys]
        p = _chunk_probs(qi, kc, row, scale, causal=causal, window=window)
        dv[:, :keys] += torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype), gi)
        dp = torch.einsum("bqhd,bkhd->bhqk", gi, vc).float()
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
        dq[:, row:row + n] = torch.einsum("bhqk,bkhd->bqhd", ds,
                                          kc.float())[:, :n]
        dk[:, :keys] += torch.einsum("bhqk,bqhd->bkhd", ds, qi.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention against a cache.

    q [B,1,H,D], caches [B,Sc,H,D(v)] (head-repeated), cache_len [] or [B]
    (an int or a tensor; a tensor on the device stays there, no host sync).
    The new token's k/v must already be written into the cache at position
    cache_len - 1 (ring-indexed for windowed caches). ``scale``: the
    softmax scale (None: 1/sqrt(D)).
    """
    B, Sc = k_cache.shape[0], k_cache.shape[1]
    scale = _scale(scale, q.shape[-1])
    if isinstance(k_cache, DTensor) and any(
            p.is_shard(1) for p in k_cache.placements):
        return _split_decode_attention(q, k_cache, v_cache, cache_len, scale)
    s = _scores(q, k_cache, scale)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(Sc, device=q.device)[None] < n.expand(B, 1)  # [B,Sc]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache)


def _split_decode_attention(q: DTensor, k_cache: DTensor, v_cache: DTensor,
                            cache_len, scale: float) -> DTensor:
    """``decode_attention`` against caches split on their sequence, as
    GSPMD evaluates it: each device scores its cache shard (masked past
    ``cache_len`` by global position), and its max, sum of exponentials
    and exponential-weighted values are reduced over the sequence's mesh
    dims; q is gathered to the caches' batch layout."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch import kernels
    mesh = k_cache.device_mesh
    split = [p.is_shard(1) for p in k_cache.placements]
    rows = [Replicate() if s or p.is_partial() else p
            for s, p in zip(split, k_cache.placements)]

    def reduced(t, op, shape):
        return kernels.from_local(t, mesh, [
            Partial(op) if s else r for s, r in zip(split, rows)],
            shape).redistribute(mesh, rows).to_local()

    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    _, offset = compute_local_shape_and_global_offset(
        k_cache.shape, mesh, k_cache.placements)
    B, H = q.shape[0], q.shape[2]
    s = _scores(ql, kl, scale)                                # [b,H,1,sc]
    if isinstance(cache_len, DTensor):
        cache_len = cache_len.full_tensor()
    n = torch.as_tensor(cache_len, device=kl.device).reshape(-1, 1)
    pos = offset[1] + torch.arange(kl.shape[1], device=kl.device)
    valid = pos[None] < n.expand(kl.shape[0], 1)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = reduced(s.amax(-1, keepdim=True), "max", (B, H, 1, 1))
    e = torch.exp(s - m)
    den = reduced(e.sum(-1, keepdim=True), "sum", (B, H, 1, 1))
    o = reduced(torch.einsum("bhqk,bkhd->bqhd", e, vl.float()), "sum",
                (B, 1, H, v_cache.shape[-1]))
    o = (o / den.permute(0, 2, 1, 3)).to(v_cache.dtype)
    return kernels.from_local(o, mesh, rows, (B, 1, H, v_cache.shape[-1]))
