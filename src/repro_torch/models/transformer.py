"""Decoder blocks of the dense and VLM architectures (PyTorch port of the
GQA and MLP half of ``repro.models.transformer``).

Each block is (param-defs fn, apply fn) over plain parameter trees. Caches
are trees of the same kind; decode writes the new token's k/v at its slot
(ring-indexed for windowed and chunked-local layers).

Attention layer kinds:
  full          causal full attention
  window        sliding window (cfg.window)
  chunked       llama4-style chunked-local (aligned chunks of
                cfg.chunked_local)
  bidir         encoder self attention
  cross         whisper's cross attention: not ported yet (ROADMAP A8)

The full-sequence attention of every kind runs the hand-written Hopper
kernel (``kernels/flash_gqa/ops.flash_gqa``) on a CUDA device and the
reference's plain algorithm (``attention.attention``) on the CPU. MLA and
MoE blocks are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.flash_gqa import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models.modules import (ParamSpec, apply_norm, gelu,
                                        norm_defs, swiglu)


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
# that a decode step copies nothing from the host
@functools.lru_cache(maxsize=None)
def _kv_index(cfg, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_kv_map(cfg), dtype=torch.long, device=device)


@functools.lru_cache(maxsize=None)
def _head_mask_on(cfg, device: torch.device, dtype) -> torch.Tensor:
    return torch.as_tensor(_head_mask(cfg), dtype=dtype, device=device)


def _expand_kv(cfg, k):
    """kv [B,S,Hkv(padded),hd] -> per-q-head kv [B,S,Hq,hd]."""
    Hq, Hkv = _heads(cfg)
    if Hq == cfg.num_heads and cfg.num_heads // max(cfg.num_kv_heads, 1) == 1 \
            and Hkv == cfg.num_kv_heads:
        return k
    return k.index_select(2, _kv_index(cfg, k.device))


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
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, Hq, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Hkv, hd)
    q = sh(q, "batch", "act_seq_q", "act_heads", None)
    k = sh(k, "batch", None, None, None)
    v = sh(v, "batch", None, None, None)
    if cfg.rope_theta > 0:
        if cfg.mrope and mrope_positions is not None:
            q = A.apply_mrope(q, mrope_positions, cfg.rope_theta,
                              cfg.mrope_sections)
            k = A.apply_mrope(k, mrope_positions, cfg.rope_theta,
                              cfg.mrope_sections)
        else:
            q = A.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
            k = A.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _attend(cfg, q, k, v, *, causal: bool, window: int):
    """Full-sequence attention of q [B,S,Hq,hd] against k/v at kv-head
    layout [B,S,Hkv,hd]: the flash_gqa kernel on CUDA (k and v read through
    ``_kv_map``, never repeated), the reference's algorithm on the CPU."""
    if q.device.type == "cuda":
        return flash_ops.flash_gqa(q, k, v, causal=causal, window=window,
                                   kv_head=_kv_map(cfg))
    return A.attention(q, _expand_kv(cfg, k), _expand_kv(cfg, v),
                       impl=cfg.attn_impl, causal=causal, window=window,
                       chunk=cfg.attn_chunk)


def attn_apply(cfg, p, x, sh, *, positions, layer_kind: str = "full",
               cache: dict | None = None, cache_len=None,
               mrope_positions=None):
    """Returns (out, kv). Full-sequence mode when ``cache`` is None: kv is
    this layer's {"k", "v"} [B,S,Hkv,hd] before any head repeat, in the
    compute dtype. Decode mode (one token at ``cache_len``, an int32
    tensor on the device) writes the token's k/v into ``cache`` IN PLACE
    and returns that same cache: unlike the reference, which returns a new
    one, the caller's cache is updated. A slot outside the cache raises
    (``index_copy_`` bounds-checks; on CUDA as a device-side assert) where
    the reference would clamp it."""
    B, S, d = x.shape
    h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)

    if layer_kind == "cross":
        raise NotImplementedError("cross attention (whisper) is not ported "
                                  "yet (ROADMAP A8)")

    if cache is None:
        q, k, v = _qkv(cfg, p, h, sh, positions, mrope_positions)
        if layer_kind == "chunked":
            o = _chunk_local_attention(cfg, q, k, v)
        else:
            o = _attend(cfg, q, k, v, causal=(layer_kind != "bidir"),
                        window=cfg.window if layer_kind == "window" else 0)
        o = _apply_head_mask(cfg, sh(o, "batch", "act_seq_q", "act_heads",
                                     None))
        out = o.reshape(B, S, -1) @ p["wo"].to(h.dtype)
        kv = {"k": k.to(cfg.compute_dtype), "v": v.to(cfg.compute_dtype)}
        return x + sh(out, "batch", "seq", "act_embed"), kv

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
                           _expand_kv(cfg, cache["v"]), valid)
    o = _apply_head_mask(cfg, o)
    out = o.reshape(B, S, -1) @ p["wo"].to(h.dtype)
    return x + sh(out, "batch", "seq", "act_embed"), cache


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
# MLA attention block (deepseek-v2): not ported yet
# ---------------------------------------------------------------------------

def _mla_not_ported(*_, **__):
    raise NotImplementedError("MLA attention is not ported yet (ROADMAP A7)")


mla_defs = mla_cache_defs = mla_apply = _mla_not_ported


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


def mlp_apply(cfg, p, x, sh):
    h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    if cfg.mlp_kind == "swiglu":
        g = h @ p["w_gate"].to(h.dtype)
        u = h @ p["w_up"].to(h.dtype)
        z = sh(swiglu(g, u), "batch", None, "act_mlp")
        out = z @ p["w_down"].to(h.dtype)
    else:
        u = gelu(h @ p["w_up"].to(h.dtype) + p["b_up"].to(h.dtype))
        u = sh(u, "batch", None, "act_mlp")
        out = u @ p["w_down"].to(h.dtype) + p["b_down"].to(h.dtype)
    return x + sh(out, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# Generic decoder layer = attention block + mlp block
# ---------------------------------------------------------------------------

def _check_ported(attn: str, mlp: str):
    if attn == "mla" or mlp == "moe":
        raise NotImplementedError(f"{attn}/{mlp} layers are not ported yet "
                                  "(ROADMAP A7)")


def layer_defs(cfg, *, attn: str = "gqa", mlp: str = "mlp",
               d_ff: int | None = None) -> dict:
    _check_ported(attn, mlp)
    defs: dict[str, Any] = {}
    defs["attn"] = attn_defs(cfg)
    defs["mlp"] = mlp_defs(cfg, d_ff)
    return defs


def layer_apply(cfg, p, x, sh, *, positions, attn="gqa", mlp="mlp",
                layer_kind="full", cache=None, cache_len=None,
                mrope_positions=None):
    """-> (x, kv or cache, aux); see ``attn_apply`` for the cache."""
    _check_ported(attn, mlp)
    x, new_cache = attn_apply(cfg, p["attn"], x, sh, positions=positions,
                              layer_kind=layer_kind, cache=cache,
                              cache_len=cache_len,
                              mrope_positions=mrope_positions)
    return mlp_apply(cfg, p["mlp"], x, sh), new_cache, 0.0
