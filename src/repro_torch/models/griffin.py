"""RecurrentGemma / Griffin recurrent block (PyTorch port of
``repro.models.griffin``): RG-LRU recurrence; its local attention is the
windowed GQA block of ``models/transformer.py``.

Recurrent block: x -> [linear -> causal conv -> RG-LRU] * gelu(linear) -> out.
RG-LRU: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(L) * sigmoid(W_a x_t)), i_t = sigmoid(W_i x_t).
[arXiv:2402.19427]

The reference computes the full-sequence recurrence with
``jax.lax.associative_scan`` outside any Pallas kernel, so the port has no
kernel here either: ``_rglru`` is a log-depth scan in plain PyTorch over
the same combine, in f32. Decode updates the conv ring and the state in
place.
"""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import _causal_conv, softplus
from repro_torch.models.modules import ParamSpec, apply_norm, gelu, norm_defs

RG_C = 8.0


def rec_defs(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "ln": norm_defs(cfg.norm_kind, d),
        "wx": ParamSpec((d, w), ("embed", "mlp")),
        "wy": ParamSpec((d, w), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, w), ("conv", "mlp")),
        "conv_b": ParamSpec((w,), ("mlp",), init="zeros"),
        "w_a": ParamSpec((w, w), ("mlp", None)),
        "w_i": ParamSpec((w, w), ("mlp", None)),
        "lam": ParamSpec((w,), ("mlp",), init="ones"),   # softplus(lam) > 0
        "out": ParamSpec((w, d), ("mlp", "embed")),
    }


def rec_cache_defs(cfg, batch: int) -> dict:
    w = cfg.lru_width
    return {
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, w),
                          ("cache_batch", None, "cache_heads"),
                          init="zeros", dtype=cfg.compute_dtype),
        "state": ParamSpec((batch, w), ("cache_batch", "cache_heads"),
                           init="zeros", dtype=torch.float32),
    }


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 1 of the combine (a1, b1), (a2, b2) ->
    (a1 * a2, a2 * b1 + b2), which ``jax.lax.associative_scan`` runs in the
    reference: log2(S) doubling steps (Hillis-Steele), each combining every
    position with the prefix ``off`` steps before it. The products are
    grouped otherwise than the reference's tree, so the sums agree to f32
    rounding."""
    S, off = a.shape[1], 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return a, b


def _rglru(xc, a_gate, i_gate, lam, init_state=None):
    """xc [B,S,W] conv output; gates [B,S,W]. Returns (y, final_state)."""
    log_a = (-RG_C * softplus(lam.float())[None, None]
             * torch.sigmoid(a_gate.float()))                       # [B,S,W]
    a = torch.exp(log_a)
    gated = torch.sigmoid(i_gate.float()) * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    if init_state is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([init_state.float()[:, None], b], dim=1)
    _, bv = _scan(a, b)
    h = bv if init_state is None else bv[:, 1:]
    return h.to(xc.dtype), bv[:, -1]


def rec_apply(cfg, p, x, sh, *, cache=None, **_):
    """Full sequence when ``cache`` is None (-> (out, None)); otherwise one
    token, whose conv ring and RG-LRU state are written into ``cache`` IN
    PLACE (-> (out, cache)), where the reference returns a new cache."""
    B, S, d = x.shape
    h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    xb = sh.dot(h, p["wx"].to(h.dtype))                     # recurrent branch
    yb = gelu(sh.dot(h, p["wy"].to(h.dtype)))               # gate branch
    xb = sh(xb, "batch", None, "act_mlp")

    if cache is None:
        xc, _ = _causal_conv(xb, p["conv_w"].to(h.dtype),
                             p["conv_b"].to(h.dtype), act=False)
        # on a mesh the gates take xb's layout, the sequence whole, so the
        # scan over it runs on each device's shard; DTensor would reduce
        # the products' partial sums onto a sequence split instead
        a_gate = sh(sh.dot(xc, p["w_a"].to(h.dtype)), "batch", None,
                    "act_mlp")
        i_gate = sh(sh.dot(xc, p["w_i"].to(h.dtype)), "batch", None,
                    "act_mlp")
        y, _ = _rglru(xc, a_gate, i_gate, p["lam"])
    else:
        conv_in = torch.cat([cache["conv"].to(h.dtype), xb], dim=1)
        w = p["conv_w"].to(h.dtype)
        xc = ((conv_in * w[None]).sum(dim=1, keepdim=True)
              + p["conv_b"].to(h.dtype)[None, None])
        a_gate = sh.dot(xc, p["w_a"].to(h.dtype))
        i_gate = sh.dot(xc, p["w_i"].to(h.dtype))
        log_a = (-RG_C * softplus(p["lam"].float())[None]
                 * torch.sigmoid(a_gate[:, 0].float()))
        a = torch.exp(log_a)
        gated = torch.sigmoid(i_gate[:, 0].float()) * xc[:, 0].float()
        new_state = (a * cache["state"]
                     + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
                     * gated)
        y = new_state.to(xc.dtype)[:, None]
        cache["conv"].copy_(conv_in[:, 1:])
        cache["state"].copy_(new_state)

    out = sh.dot(y * yb, p["out"].to(h.dtype))
    return x + sh(out, "batch", "seq", "act_embed"), cache
