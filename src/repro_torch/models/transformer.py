"""Decoder blocks (PyTorch port of ``repro.models.transformer``): the GQA
attention block of the dense and VLM architectures, deepseek-v2's MLA
block, the MLPs, and the generic layer over them (its MoE block is
``models/moe.py``).

Each block is (param-defs fn, apply fn) over plain parameter trees. Caches
are trees of the same kind; decode writes the new token's k/v at its slot
(ring-indexed for windowed and chunked-local layers).

Attention layer kinds:
  full          causal full attention
  window        sliding window (cfg.window)
  chunked       llama4-style chunked-local (aligned chunks of
                cfg.chunked_local)
  bidir         encoder self attention
  cross         whisper's encoder-decoder cross attention (no mask, no
                rope; k/v from the encoder output)

The full-sequence attention of every kind runs the hand-written Hopper
kernel (``kernels/flash_gqa/ops.flash_gqa``) on a CUDA device where the
kernel takes the shapes, and the reference's plain algorithm
(``attention.attention``) elsewhere: on the CPU, and on CUDA for shapes
the kernel does not take (``flash_gqa.takes``), which ``flash_gqa.routed``
counts. Cross attention goes the same way with Sq != Skv and no mask, at
the prefill and at every decode step. MLA's prefill attends through the
same path (q/k 192, v 128 at deepseek-v2-lite's width); its decode attends
over the compressed cache with the absorbed projections, in plain
PyTorch.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import kernels
from repro_torch.kernels._autograd import index_select
from repro_torch.kernels.flash_gqa import flash_gqa as FK
from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.modules import (ParamSpec, apply_norm, gelu,
                                        norm_defs, residual, swiglu)
from repro_torch.obs.spans import span, spanned


# ---------------------------------------------------------------------------
# Attention block (GQA family)
# ---------------------------------------------------------------------------

def _heads(cfg) -> tuple[int, int]:
    """(q_heads, kv_heads) including the reference's head padding (see
    configs/base.py)."""
    return (cfg.pad_q_heads or cfg.num_heads,
            cfg.pad_kv_heads or cfg.num_kv_heads)


def _kv_map(cfg) -> np.ndarray:
    """Static q-head -> kv-head index map honoring the UNPADDED grouping;
    padded q heads read kv head 0."""
    Hq, _ = _heads(cfg)
    g = cfg.num_heads // max(cfg.num_kv_heads, 1)
    idx = [min(h // g, cfg.num_kv_heads - 1) if h < cfg.num_heads else 0
           for h in range(Hq)]
    return np.asarray(idx, dtype=np.int32)


def _head_mask(cfg) -> np.ndarray | None:
    Hq, _ = _heads(cfg)
    if Hq == cfg.num_heads:
        return None
    return np.asarray([1.0 if h < cfg.num_heads else 0.0 for h in range(Hq)],
                      dtype=np.float32)


# _kv_map and _head_mask as tensors, made once per config and device, so
# that a decode step copies nothing from the host. They are made outside
# inference mode wherever the first call comes from: a tensor made under
# serving's inference_mode could not be saved for a later train step's
# backward
@functools.lru_cache(maxsize=None)
def _kv_index(cfg, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(_kv_map(cfg), dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _head_mask_on(cfg, device: torch.device, dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(_head_mask(cfg), dtype=dtype, device=device)


def _expand_kv(cfg, k):
    """kv [B,S,Hkv(padded),hd] -> per-q-head kv [B,S,Hq,hd]."""
    Hq, Hkv = _heads(cfg)
    if Hq == cfg.num_heads and cfg.num_heads // max(cfg.num_kv_heads, 1) == 1 \
            and Hkv == cfg.num_kv_heads:
        return k
    return index_select(k, 2, _kv_index(cfg, k.device))


def _apply_head_mask(cfg, o):
    """Zero the outputs of padded q heads (the reference's ``_head_mask``)."""
    if _head_mask(cfg) is None:
        return o
    return o * _head_mask_on(cfg, o.device, o.dtype)[None, None, :, None]


def attn_defs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = _heads(cfg)
    return {
        "ln": norm_defs(cfg.norm_kind, d),
        "wq": ParamSpec((d, Hq * hd), ("embed", "heads_q")),
        "wk": ParamSpec((d, Hkv * hd), ("embed", "heads_kv")),
        "wv": ParamSpec((d, Hkv * hd), ("embed", "heads_kv")),
        "wo": ParamSpec((Hq * hd, d), ("heads_q", "embed")),
    }


def attn_cache_defs(cfg, batch: int, cache_len: int, long: bool = False
                    ) -> dict:
    hd = cfg.resolved_head_dim
    _, Hkv = _heads(cfg)
    seq_ax = "cache_seq_sharded" if long else "cache_seq"
    axes = ("cache_batch", seq_ax, "cache_heads", None)
    shp = (batch, cache_len, Hkv, hd)
    return {"k": ParamSpec(shp, axes, init="zeros", dtype=cfg.compute_dtype),
            "v": ParamSpec(shp, axes, init="zeros", dtype=cfg.compute_dtype)}


def _qkv(cfg, p, x, sh, positions, mrope_positions=None):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = _heads(cfg)
    q = sh.dot(x, p["wq"].to(x.dtype)).reshape(B, S, Hq, hd)
    k = sh.dot(x, p["wk"].to(x.dtype)).reshape(B, S, Hkv, hd)
    v = sh.dot(x, p["wv"].to(x.dtype)).reshape(B, S, Hkv, hd)
    q = sh(q, "batch", "act_seq_q", "act_heads", None)
    k = sh(k, "batch", None, None, None)
    v = sh(v, "batch", None, None, None)
    if cfg.rope_theta > 0:
        with span("model.attn.rope"):
            if cfg.mrope and mrope_positions is not None:
                q = A.apply_mrope(q, mrope_positions, cfg.rope_theta,
                                  cfg.mrope_sections)
                k = A.apply_mrope(k, mrope_positions, cfg.rope_theta,
                                  cfg.mrope_sections)
            else:
                q = A.apply_rope(q, positions, cfg.rope_theta,
                                 cfg.rope_fraction)
                k = A.apply_rope(k, positions, cfg.rope_theta,
                                 cfg.rope_fraction)
    return q, k, v


def _scale(cfg, D: int) -> float:
    """The softmax scale of the config's attention over heads of ``D``:
    its ``attention_multiplier``, or 1/sqrt(D) where that is 0 (the value
    the kernels and ``models/attention`` take by default)."""
    return cfg.attention_multiplier or 1.0 / math.sqrt(D)


def _attend(cfg, q, k, v, *, causal: bool, window: int):
    """Full-sequence attention of q [B,Sq,Hq,hd] against k/v at kv-head
    layout [B,Skv,Hkv,hd] (Skv differs from Sq only with no mask), at the
    config's softmax scale (``_scale``): the flash_gqa kernel on CUDA (and
    on meta, the dry run's stand-in for the card) where it takes the
    shapes (k and v read through ``_kv_map``, never repeated), else the
    reference's algorithm; such a call sent there is counted in
    ``FK.routed``."""
    if kernels.kernel_route(q):
        if FK.takes(q.shape, k.shape, v.shape, causal=causal,
                    window=window):
            return flash_ops.flash_gqa(q, k, v, causal=causal,
                                       window=window, kv_head=_kv_map(cfg),
                                       impl=cfg.attn_impl,
                                       chunk=cfg.attn_chunk,
                                       scale=_scale(cfg, q.shape[-1]))
        FK.count_routed()
    k, v = _expand_kv(cfg, k), _expand_kv(cfg, v)
    if isinstance(q, DTensor):
        return _attention_on_mesh(cfg, q, k, v, causal=causal,
                                  window=window)
    return A.attention(q, k, v, impl=cfg.attn_impl, causal=causal,
                       window=window, chunk=cfg.attn_chunk,
                       scale=_scale(cfg, q.shape[-1]))


def _attention_on_mesh(cfg, q, k, v, *, causal: bool, window: int):
    """The reference's algorithm on DTensors q, k, v [B,S,H,D] (k and v at
    q's heads), on each device's shard: each keeps q's batch and head
    splits (any other split is gathered), so the attention of each (batch,
    head) is local, whatever DTensor's per-operation strategy would pick.
    -> o laid out as q."""
    lay = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
           for p in q.placements]
    mesh = q.device_mesh
    q, k, v = (t.redistribute(mesh, lay) for t in (q, k, v))
    o = A.attention(q.to_local(), k.to_local(), v.to_local(),
                    impl=cfg.attn_impl, causal=causal, window=window,
                    chunk=cfg.attn_chunk,
                    scale=_scale(cfg, q.shape[-1]))
    return kernels.from_local(o, mesh, lay, (*q.shape[:3], v.shape[3]))


@spanned("model.attn")
def attn_apply(cfg, p, x, sh, *, positions, layer_kind: str = "full",
               cache: dict | None = None, cache_len=None,
               mrope_positions=None, kv_override=None):
    """Returns (out, kv). Full-sequence mode when ``cache`` is None: kv is
    this layer's {"k", "v"} [B,S,Hkv,hd] before any head repeat, in the
    compute dtype. Decode mode (one token at ``cache_len``, an int32
    tensor on the device) writes the token's k/v into ``cache`` IN PLACE
    and returns that same cache: unlike the reference, which returns a new
    one, the caller's cache is updated. A slot outside the cache raises
    (``index_copy_`` bounds-checks; on CUDA as a device-side assert) where
    the reference would clamp it. ``layer_kind="cross"`` attends the
    queries of x, at any length, to k/v projected from ``kv_override``
    (the encoder output [B,Senc,d]) with no mask and no rope, and returns
    ``cache`` as it was given."""
    B, S, d = x.shape
    with span("model.attn.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)

    if layer_kind == "cross":
        hd = cfg.resolved_head_dim
        Hq, Hkv = _heads(cfg)
        enc = kv_override
        q = sh.dot(h, p["wq"].to(h.dtype)).reshape(B, S, Hq, hd)
        k = sh.dot(enc, p["wk"].to(h.dtype)).reshape(B, enc.shape[1], Hkv, hd)
        v = sh.dot(enc, p["wv"].to(h.dtype)).reshape(B, enc.shape[1], Hkv, hd)
        o = _attend(cfg, q, k, v, causal=False, window=0)
        out = sh.dot(o.reshape(B, S, -1), p["wo"].to(h.dtype))
        return residual(cfg, x, sh(out, "batch", "seq", "act_embed")), cache

    if cache is None:
        q, k, v = _qkv(cfg, p, h, sh, positions, mrope_positions)
        if layer_kind == "chunked":
            o = _chunk_local_attention(cfg, q, k, v)
        else:
            o = _attend(cfg, q, k, v, causal=(layer_kind != "bidir"),
                        window=cfg.window if layer_kind == "window" else 0)
        o = _apply_head_mask(cfg, sh(o, "batch", "act_seq_q", "act_heads",
                                     None))
        out = sh.dot(o.reshape(B, S, -1), p["wo"].to(h.dtype))
        kv = {"k": k.to(cfg.compute_dtype), "v": v.to(cfg.compute_dtype)}
        return residual(cfg, x, sh(out, "batch", "seq", "act_embed")), kv

    # ---- decode: single token against a cache ----
    pos = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, h, sh, positions, mrope_positions)
    W = cache["k"].shape[1]
    if layer_kind == "chunked":
        slot = pos % cfg.chunked_local
        valid = slot + 1
    elif layer_kind == "window":
        slot = pos % W
        valid = torch.clamp(pos + 1, max=W)
    else:
        slot = pos
        valid = pos + 1
    idx = slot.reshape(1).long()
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    o = A.decode_attention(q, _expand_kv(cfg, cache["k"]),
                           _expand_kv(cfg, cache["v"]), valid,
                           _scale(cfg, q.shape[-1]))
    o = _apply_head_mask(cfg, o)
    out = sh.dot(o.reshape(B, S, -1), p["wo"].to(h.dtype))
    return residual(cfg, x, sh(out, "batch", "seq", "act_embed")), cache


def _chunk_local_attention(cfg, q, k, v):
    """llama4 chunked-local: attend within aligned chunks of
    cfg.chunked_local. k/v at kv-head layout."""
    B, S, H, D = q.shape
    C = cfg.chunked_local
    if S <= C:
        return _attend(cfg, q, k, v, causal=True, window=0)
    assert S % C == 0, (S, C)
    n = S // C
    qc = q.reshape(B * n, C, H, D)
    kc = k.reshape(B * n, C, k.shape[2], D)
    vc = v.reshape(B * n, C, v.shape[2], v.shape[-1])
    o = _attend(cfg, qc, kc, vc, causal=True, window=0)
    return o.reshape(B, S, H, v.shape[-1])


# ---------------------------------------------------------------------------
# MLA attention block (deepseek-v2)
# ---------------------------------------------------------------------------

def mla_defs(cfg) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        "ln": norm_defs(cfg.norm_kind, d),
        "wq": ParamSpec((d, H * (nope + rope_d)), ("embed", "heads_q")),
        "w_dkv": ParamSpec((d, r + rope_d), ("embed", "kv_lora")),
        "kv_ln": norm_defs("rms", r),
        "w_uk": ParamSpec((r, H * nope), ("kv_lora", "heads_q")),
        "w_uv": ParamSpec((r, H * vd), ("kv_lora", "heads_q")),
        "wo": ParamSpec((H * vd, d), ("heads_q", "embed")),
    }


def mla_cache_defs(cfg, batch: int, cache_len: int, long: bool = False
                   ) -> dict:
    seq_ax = "cache_seq_sharded" if long else "cache_seq"
    return {
        "ckv": ParamSpec((batch, cache_len, cfg.kv_lora_rank),
                         ("cache_batch", seq_ax, None),
                         init="zeros", dtype=cfg.compute_dtype),
        "krope": ParamSpec((batch, cache_len, cfg.qk_rope_head_dim),
                           ("cache_batch", seq_ax, None),
                           init="zeros", dtype=cfg.compute_dtype),
    }


def _mla_qc(cfg, p, h, sh, positions):
    """Shared q / compressed-kv computation. Returns q_nope, q_rope, ckv,
    krope."""
    B, S, _ = h.shape
    H = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    q = sh.dot(h, p["wq"].to(h.dtype)).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    with span("model.attn.rope"):
        q_rope = A.apply_rope(q_rope, positions, cfg.rope_theta)
    c = sh.dot(h, p["w_dkv"].to(h.dtype))                     # [B,S,r+rope]
    with span("model.attn.norm"):
        ckv = apply_norm("rms", p["kv_ln"], c[..., :r], cfg.norm_eps)
    with span("model.attn.rope"):
        krope = A.apply_rope(c[..., None, r:], positions,
                             cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, krope


@spanned("model.attn")
def mla_apply(cfg, p, x, sh, *, positions, cache: dict | None = None,
              cache_len=None, **_):
    """Returns (out, cache). Full-sequence mode when ``cache`` is None: k
    and v are materialized per head and attend through ``_attend`` (the
    flash_gqa kernel on CUDA where it takes the head dims, q/k 192 with v
    128 at full width); the cache is this layer's compressed {"ckv",
    "krope"}. Decode mode (one token at ``cache_len``, an int32 tensor on
    the device) writes the token's ckv and krope into ``cache`` IN PLACE,
    as the GQA block does, and attends with the absorbed projections over
    the compressed cache."""
    B, S, d = x.shape
    H = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim
    r = cfg.kv_lora_rank
    with span("model.attn.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    q_nope, q_rope, ckv, krope = _mla_qc(cfg, p, h, sh, positions)

    if cache is None:
        # decompressed path: materialize per-head k/v (prefill). The
        # softmax scale is 1/sqrt(nope + rope), q's head dim.
        k_nope = sh.dot(ckv, p["w_uk"].to(h.dtype)).reshape(B, S, H, nope)
        v = sh.dot(ckv, p["w_uv"].to(h.dtype)).reshape(B, S, H, vd)
        with span("model.attn.rope"):
            k = torch.cat([k_nope,
                           krope[:, :, None].expand(B, S, H, rope_d)], -1)
            q = torch.cat([q_nope, q_rope], -1)
        q = sh(q, "batch", "act_seq_q", "act_heads", None)
        o = _attend(cfg, q, k, v, causal=True, window=0)
        out = sh.dot(o.reshape(B, S, -1), p["wo"].to(h.dtype))
        new_cache = {"ckv": ckv, "krope": krope}
        return x + sh(out, "batch", "seq", "act_embed"), new_cache

    # ---- decode with absorbed projections (cache stays compressed) ----
    pos = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
    idx = pos.reshape(1).long()
    cache["ckv"].index_copy_(1, idx, ckv.to(cache["ckv"].dtype))
    cache["krope"].index_copy_(1, idx, krope.to(cache["krope"].dtype))
    ckv_c, krope_c = cache["ckv"], cache["krope"]
    w_uk = p["w_uk"].to(h.dtype).reshape(r, H, nope)
    w_uv = p["w_uv"].to(h.dtype).reshape(r, H, vd)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)         # [B,1,H,r]
    # the reference asks these two products for f32 results: the operands
    # widened to f32 give the same exact products, summed in f32
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs.float(), ckv_c.float())
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krope_c.float())
         ) * (1.0 / math.sqrt(nope + rope_d))
    Sc = ckv_c.shape[1]
    valid = torch.arange(Sc, device=x.device) < (pos + 1)
    s = s.masked_fill(~valid, A.NEG_INF)
    pr = torch.softmax(s, dim=-1).to(h.dtype)
    o_c = torch.einsum("bhqk,bkr->bqhr", pr, ckv_c)              # [B,1,H,r]
    o = torch.einsum("bqhr,rhd->bqhd", o_c, w_uv)
    out = sh.dot(o.reshape(B, S, -1), p["wo"].to(h.dtype))
    return x + sh(out, "batch", "seq", "act_embed"), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"ln": norm_defs(cfg.norm_kind, d),
                "w_gate": ParamSpec((d, f), ("embed", "mlp")),
                "w_up": ParamSpec((d, f), ("embed", "mlp")),
                "w_down": ParamSpec((f, d), ("mlp", "embed"))}
    return {"ln": norm_defs(cfg.norm_kind, d),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "b_up": ParamSpec((f,), ("mlp",), init="zeros"),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
            "b_down": ParamSpec((d,), ("embed",), init="zeros")}


@spanned("model.ffn")
def mlp_apply(cfg, p, x, sh):
    with span("model.ffn.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    if cfg.mlp_kind == "swiglu":
        g = sh.dot(h, p["w_gate"].to(h.dtype))
        u = sh.dot(h, p["w_up"].to(h.dtype))
        with span("model.ffn.act"):
            z = swiglu(g, u)
        z = sh(z, "batch", None, "act_mlp")
        out = sh.dot(z, p["w_down"].to(h.dtype))
    else:
        u = sh.dot(h, p["w_up"].to(h.dtype)) + p["b_up"].to(h.dtype)
        with span("model.ffn.act"):
            u = gelu(u)
        u = sh(u, "batch", None, "act_mlp")
        out = sh.dot(u, p["w_down"].to(h.dtype)) + p["b_down"].to(h.dtype)
    return x + sh(out, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# Generic decoder layer = attention block + mlp/moe block
# ---------------------------------------------------------------------------

def layer_defs(cfg, *, attn: str = "gqa", mlp: str = "mlp",
               d_ff: int | None = None) -> dict:
    defs: dict[str, Any] = {}
    defs["attn"] = mla_defs(cfg) if attn == "mla" else attn_defs(cfg)
    defs["mlp"] = moe_defs(cfg) if mlp == "moe" else mlp_defs(cfg, d_ff)
    return defs


def layer_apply(cfg, p, x, sh, *, positions, attn="gqa", mlp="mlp",
                layer_kind="full", cache=None, cache_len=None,
                mrope_positions=None):
    """-> (x, kv or cache, aux); see ``attn_apply`` and ``mla_apply`` for
    the cache."""
    fn = mla_apply if attn == "mla" else attn_apply
    x, new_cache = fn(cfg, p["attn"], x, sh, positions=positions,
                      layer_kind=layer_kind, cache=cache, cache_len=cache_len,
                      mrope_positions=mrope_positions)
    if mlp == "moe":
        x, aux = moe_apply(cfg, p["mlp"], x, sh)
    else:
        x, aux = mlp_apply(cfg, p["mlp"], x, sh), 0.0
    return x, new_cache, aux
