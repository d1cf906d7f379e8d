"""Model assembly: config -> ModelBundle (loss / prefill / decode + defs),
PyTorch port of ``repro.models.model``.

A bundle is everything launch/ needs:
  param_defs            ParamSpec tree (init, counts)
  loss_fn(p, batch)     -> (loss, metrics)          [train]
  prefill_fn(p, batch)  -> (last_logits, cache)
  decode_fn(p, cache, batch) -> (logits, cache)
  cache_defs(batch, cache_len, long) -> ParamSpec tree (+ "len" scalar)
  batch_defs(shape)     -> ParamSpec tree of inputs
  encode(p, frames)     -> encoder output           [whisper only]

Layers are stacked on a leading "layers" dim as in the reference (llama4
over super-blocks of 4 sub-layers, griffin over (rec, rec, attn) triples
with the remainder unrolled, whisper's 4 + 4 layers unrolled); its
``jax.lax.scan`` over that dim is a Python loop here. Every family of the
reference serves: the ``ssm`` family (Mamba-2), the homogeneous decoder
LMs (``dense`` and ``vlm``: glm4, granite, smollm, starcoder2, qwen2-vl),
the ``moe`` family (deepseek-v2 with MLA attention, llama4 with GQA), the
``hybrid`` griffin (recurrentgemma) and the ``audio`` encoder-decoder
(whisper); the ``hybrid_moe`` family (granite-4.0-h: Mamba-2 and NoPE
attention mixers by ``layer_types``, a MoE after each) is the port's
own. Every family trains: ``loss_fn`` is the reference's (f32 cross
entropy over the unpadded vocabulary, chunked along the sequence when
``cfg.logit_chunk`` says so, plus ``AUX_WEIGHT`` x the MoE aux loss over
the layers), and the layer bodies the reference rematerializes run under
``torch.utils.checkpoint`` (``_maybe_remat``). Decode writes every cache
in place and returns the same tree with ``len`` + 1.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import griffin as G
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.modules import (ParamSpec, Sharder, apply_norm,
                                        norm_defs, recomputed,
                                        softmax_cross_entropy, stack_specs,
                                        token_nll, tree_map)
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.obs.spans import count, recording, span

AUX_WEIGHT = 0.01


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    param_defs: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_defs: Callable
    batch_defs: Callable
    encode: Callable | None = None


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _vpad(cfg) -> int:
    return cfg.pad_vocab_to or cfg.vocab_size


def _embed_defs(cfg) -> dict:
    d = {"embed": ParamSpec((_vpad(cfg), cfg.d_model), ("vocab", "embed"),
                            init="embed", init_scale=0.02),
         "final_ln": norm_defs(cfg.norm_kind, cfg.d_model)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamSpec((cfg.d_model, _vpad(cfg)),
                                 ("embed", "vocab"))
    return d


def _embed(cfg, p, tokens, sh):
    x = sh.lookup(p["embed"], tokens, cfg.compute_dtype)
    return sh(x, "batch", "seq", "act_embed")


def _head(cfg, p):
    if cfg.tie_embeddings:
        return p["embed"].T
    return p["lm_head"]


def _logits(cfg, p, h, sh):
    out = sh(sh.dot(h, _head(cfg, p).to(h.dtype)), "batch", None,
             "act_heads")
    return out[..., :cfg.vocab_size]          # drop vocab padding (serving)


def _lm_loss(cfg, p, h, targets, mask, sh):
    """CE over the final-normed h [B,S,d], in f32. Padded vocab entries are
    masked to -1e30, so padding is exact. When ``cfg.logit_chunk`` divides
    S and S exceeds it, the logits are made chunk by chunk along S, each
    chunk recomputed in the backward (``torch.utils.checkpoint``), so at
    most one chunk's [B, ck, V] logits are held."""
    head = _head(cfg, p).to(h.dtype)
    B, S, d = h.shape
    vmask = None
    if _vpad(cfg) != cfg.vocab_size:
        vmask = torch.arange(_vpad(cfg), device=h.device) < cfg.vocab_size

    def _mask(lg):
        return lg if vmask is None else torch.where(vmask, lg, -1e30)

    ck = cfg.logit_chunk
    if not ck or S % ck or S <= ck:
        logits = sh(sh.dot(h, head), "batch", None, "act_heads")
        return softmax_cross_entropy(_mask(logits.float()), targets, mask)

    def chunk(hc, head, tc, mc):                         # [B,ck,...]
        lg = _mask(sh(sh.dot(hc, head), "batch", None, "act_heads").float())
        mf = mc.float()
        return (token_nll(lg, tc) * mf).sum(), mf.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, ck):
        t, c = checkpoint(_recomputed(chunk), h[:, i:i + ck], head,
                          targets[:, i:i + ck], mask[:, i:i + ck],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


# "dots": keep the outputs of the products with no batch dims (``aten.mm``,
# which a [B,S,d] @ [d,f] projection lowers to), as the reference's
# checkpoint_dots_with_no_batch_dims keeps its dot_generals; recompute the
# rest (bmm, einsums with a batch dim, elementwise work, the kernels)
_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default])


def _maybe_remat(f, cfg, mode):
    """``f`` run under ``torch.utils.checkpoint`` in training: its
    activations are recomputed in the backward (``remat="full"``), all but
    the products with no batch dims (``"dots"``), or kept (``"none"``).
    Non-reentrant, so inputs that need no gradient keep theirs flowing."""
    if mode != "train" or cfg.remat == "none":
        return f
    kw = {"context_fn": _SAVE_DOTS} if cfg.remat == "dots" else {}
    return functools.partial(checkpoint, _recomputed(f), use_reentrant=False,
                             **kw)


def _recomputed(f):
    """``f`` marked as a body its backward recomputes
    (``modules.recomputed``)."""
    @functools.wraps(f)
    def body(*args, **kwargs):
        with recomputed():
            return f(*args, **kwargs)
    return body


def _base_batch_defs(cfg, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ParamSpec((B, S), ("batch", "seq"), "zeros", torch.int32),
                "targets": ParamSpec((B, S), ("batch", "seq"), "zeros", torch.int32),
                "mask": ParamSpec((B, S), ("batch", "seq"), "ones", torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ParamSpec((B, S), ("batch", "seq"), "zeros", torch.int32)}
    return {"token": ParamSpec((B, 1), ("batch", "seq"), "zeros", torch.int32)}


def _len_def() -> ParamSpec:
    return ParamSpec((), (), "zeros", torch.int32)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _len(S: int, device) -> torch.Tensor:
    return torch.tensor(S, dtype=torch.int32, device=device)


def _layer(stacked, i: int):
    """Layer ``i`` of a tree stacked on a leading "layers" dim (views)."""
    return tree_map(lambda t: t[i], stacked)


def _unstack(stacked, n: int) -> list:
    """The ``n`` layers of a parameter tree stacked on a leading dim, as
    trees of views. ``torch.unbind`` makes them, so a backward stacks the
    layers' gradients once, where indexing each layer would add a zero
    tensor of the whole stack per layer."""
    if isinstance(stacked, dict):
        per = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(stacked))


def _aux(total, like: torch.Tensor) -> torch.Tensor:
    """The layers' aux-loss sum as an f32 tensor on ``like``'s device: the
    sum starts from a Python 0.0, which layers without a MoE block leave
    as it is (so serving adds no kernel for it)."""
    return torch.as_tensor(total, dtype=torch.float32, device=like.device)


def _stack(layers: list):
    """Per-layer trees -> one tree stacked on a new leading dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers]) for k in first}
    return torch.stack(layers)


# ---------------------------------------------------------------------------
# family: homogeneous decoder LMs (glm4, granite, smollm, starcoder2, qwen2-vl)
# ---------------------------------------------------------------------------

def _decoder_lm(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    is_vlm = cfg.family == "vlm"
    defs = {**_embed_defs(cfg),
            "layers": stack_specs(T.layer_defs(cfg), cfg.num_layers)}
    kind = "window" if cfg.window else "full"

    def layer(pl, x, positions, cl, cache_len, mpos):
        return T.layer_apply(cfg, pl, x, sh, positions=positions,
                             layer_kind=kind, cache=cl, cache_len=cache_len,
                             mrope_positions=mpos)

    def fwd(p, x, positions, mode, cache=None, cache_len=None, mpos=None):
        """-> (final-normed x, the layers' summed aux loss, per-layer kv of
        the prefill or, in decode, the caches written in place). In
        training each layer runs under ``_maybe_remat``."""
        body = _maybe_remat(layer, cfg, mode)
        kvs, aux = [], 0.0
        for i, pl in enumerate(_unstack(p["layers"], cfg.num_layers)):
            cl = _layer(cache, i) if cache is not None else None
            x, c, a = body(pl, x, positions, cl, cache_len, mpos)
            kvs.append(c)
            aux = aux + a
        with span("model.norm"):
            x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, aux, kvs

    def embed(p, batch):
        x = _embed(cfg, p, batch["tokens"], sh)
        if is_vlm:
            vis = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
        return x

    def loss_fn(p, batch):
        B, S = batch["tokens"].shape
        x = embed(p, batch)
        x, aux, _ = fwd(p, x, _positions(B, S, x.device), "train",
                        mpos=batch.get("mrope_positions"))
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        aux = _aux(aux, ce)
        loss = ce + AUX_WEIGHT * aux / max(cfg.num_layers, 1)
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = embed(p, batch)
        # full-attention archs: the cache is the full-seq kv, stacked
        x, _, kvs = fwd(p, x, _positions(B, S, x.device), "prefill",
                        mpos=batch.get("mrope_positions"))
        with span("model.head"):
            logits = _logits(cfg, p, x[:, -1:], sh)
        with span("model.cache"):
            return logits, {"kv": _stack(kvs), "len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        """One token at ``cache["len"]``; writes the token's k/v into
        ``cache["kv"]`` in place and returns it with ``len`` + 1."""
        B = batch["token"].shape[0]
        pos = cache["len"]
        x = _embed(cfg, p, batch["token"], sh)
        positions = pos.reshape(1, 1).expand(B, 1)
        mpos = pos.reshape(1, 1, 1).expand(3, B, 1) if cfg.mrope else None
        x, _, _ = fwd(p, x, positions, "decode", cache=cache["kv"],
                      cache_len=pos, mpos=mpos)
        logits = _logits(cfg, p, x, sh)
        return logits, {"kv": cache["kv"], "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        kv = stack_specs(T.attn_cache_defs(cfg, batch, cache_len, long),
                         cfg.num_layers)
        return {"kv": kv, "len": _len_def()}

    def batch_defs(shape: ShapeConfig):
        b = _base_batch_defs(cfg, shape)
        if is_vlm and shape.kind in ("train", "prefill"):
            P = min(cfg.vision_prefix, shape.seq_len // 2)
            b["vision_embeds"] = ParamSpec(
                (shape.global_batch, P, cfg.d_model),
                ("batch", "seq", "act_embed"), "zeros", cfg.compute_dtype)
        if cfg.mrope and shape.kind in ("train", "prefill"):
            b["mrope_positions"] = ParamSpec(
                (3, shape.global_batch, shape.seq_len),
                (None, "batch", "seq"), "zeros", torch.int32)
        return b

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, batch_defs)


# ---------------------------------------------------------------------------
# family: mamba2
# ---------------------------------------------------------------------------

def _mamba(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    defs = {**_embed_defs(cfg),
            "layers": stack_specs(M.mamba_defs(cfg), cfg.num_layers)}

    def layer(pl, x, cl):
        return M.mamba_apply(cfg, pl, x, sh, cache=cl)

    def fwd(p, x, mode, cache=None):
        body = _maybe_remat(layer, cfg, mode)
        ncs = []
        for i, pl in enumerate(_unstack(p["layers"], cfg.num_layers)):
            cl = _layer(cache, i) if cache is not None else None
            x, nc = body(pl, x, cl)
            if cache is not None:
                ncs.append(nc)
        x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, (_stack(ncs) if cache is not None else None)

    def loss_fn(p, batch):
        x = _embed(cfg, p, batch["tokens"], sh)
        x, _ = fwd(p, x, "train")
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        return ce, {"loss": ce, "ce": ce}

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, _ = fwd(p, x, "prefill")
        logits = _logits(cfg, p, x[:, -1:], sh)
        return logits, {"len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        pos = cache["len"]
        x = _embed(cfg, p, batch["token"], sh)
        x, nc = fwd(p, x, "decode", cache=cache["layers"])
        logits = _logits(cfg, p, x, sh)
        return logits, {"layers": nc, "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        return {"layers": stack_specs(M.mamba_cache_defs(cfg, batch),
                                      cfg.num_layers),
                "len": _len_def()}

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, functools.partial(_base_batch_defs, cfg))


# ---------------------------------------------------------------------------
# family: deepseek-v2 (MLA; layer0 dense, rest MoE)
# ---------------------------------------------------------------------------

def _deepseek(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    n_moe = cfg.num_layers - cfg.moe.first_dense
    defs = {**_embed_defs(cfg),
            "layer0": T.layer_defs(cfg, attn="mla", mlp="mlp", d_ff=cfg.d_ff),
            "layers": stack_specs(
                T.layer_defs(cfg, attn="mla", mlp="moe"), n_moe)}

    def moe_layer(pl, x, positions, cl, cache_len):
        return T.layer_apply(cfg, pl, x, sh, positions=positions,
                             attn="mla", mlp="moe", cache=cl,
                             cache_len=cache_len)

    def fwd(p, x, positions, mode, cache=None, cache_len=None):
        """-> (final-normed x, the layers' summed aux loss, the dense
        layer's cache and the MoE layers' list of caches: each layer's
        compressed {"ckv", "krope"} of the prefill or, in decode, the
        caches written in place). In training each MoE layer runs under
        ``_maybe_remat``; the dense layer 0 does not, as in the
        reference."""
        c0 = cache["l0"] if cache is not None else None
        x, c0n, aux = T.layer_apply(cfg, p["layer0"], x, sh,
                                    positions=positions, attn="mla",
                                    cache=c0, cache_len=cache_len)
        body = _maybe_remat(moe_layer, cfg, mode)
        cs = []
        for i, pl in enumerate(_unstack(p["layers"], n_moe)):
            cl = _layer(cache["ls"], i) if cache is not None else None
            x, c, a = body(pl, x, positions, cl, cache_len)
            aux = aux + a
            cs.append(c)
        with span("model.norm"):
            x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, aux, c0n, cs

    def loss_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, aux, _, _ = fwd(p, x, _positions(B, S, x.device), "train")
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        aux = _aux(aux, ce)
        loss = ce + AUX_WEIGHT * aux / cfg.num_layers
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, _, c0, cs = fwd(p, x, _positions(B, S, x.device), "prefill")
        with span("model.head"):
            logits = _logits(cfg, p, x[:, -1:], sh)
        with span("model.cache"):
            return logits, {"l0": c0, "ls": _stack(cs),
                            "len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        """One token at ``cache["len"]``; writes the token's compressed kv
        into ``cache["l0"]`` and ``cache["ls"]`` in place and returns them
        with ``len`` + 1."""
        B = batch["token"].shape[0]
        pos = cache["len"]
        x = _embed(cfg, p, batch["token"], sh)
        positions = pos.reshape(1, 1).expand(B, 1)
        x, _, _, _ = fwd(p, x, positions, "decode", cache=cache,
                         cache_len=pos)
        logits = _logits(cfg, p, x, sh)
        return logits, {"l0": cache["l0"], "ls": cache["ls"], "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        one = T.mla_cache_defs(cfg, batch, cache_len, long)
        return {"l0": one, "ls": stack_specs(one, n_moe), "len": _len_def()}

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, functools.partial(_base_batch_defs, cfg))


# ---------------------------------------------------------------------------
# family: llama4 (super-blocks of 4: chunked/global attn x dense/moe mlp)
# ---------------------------------------------------------------------------

LLAMA4_PERIOD = 4


def _llama4_subkinds(cfg):
    """(attn_kind, mlp_kind) for each sub-layer of the 4-layer super-block."""
    out = []
    for i in range(LLAMA4_PERIOD):
        attn = "full" if (i + 1) % cfg.global_every == 0 else "chunked"
        mlp = "moe" if i % cfg.moe.every_k_layers == 1 else "mlp"
        out.append((attn, mlp))
    return out


def _llama4(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    assert cfg.num_layers % LLAMA4_PERIOD == 0
    n_sb = cfg.num_layers // LLAMA4_PERIOD
    kinds = _llama4_subkinds(cfg)
    sb_defs = {f"sub{i}": T.layer_defs(cfg, mlp=k[1],
                                       d_ff=cfg.moe.dense_d_ff)
               for i, k in enumerate(kinds)}
    defs = {**_embed_defs(cfg), "blocks": stack_specs(sb_defs, n_sb)}
    nope = cfg.replace(rope_theta=0.0)          # iRoPE: global layers NoPE

    def _l4_layer(pl, x, positions, attn_kind, mlp_kind, c, cache_len):
        lcfg = cfg if attn_kind != "full" else nope
        x, _ = T.attn_apply(lcfg, pl["attn"], x, sh, positions=positions,
                            layer_kind=attn_kind, cache=c,
                            cache_len=cache_len)
        if mlp_kind == "moe":
            return moe_apply(cfg, pl["mlp"], x, sh)
        return T.mlp_apply(cfg, pl["mlp"], x, sh), 0.0

    def super_block(pb, x, positions, cb, cache_len):
        aux = 0.0
        for i, (attn_kind, mlp_kind) in enumerate(kinds):
            x, a = _l4_layer(pb[f"sub{i}"], x, positions, attn_kind,
                             mlp_kind, cb[f"sub{i}"] if cb else None,
                             cache_len)
            aux = aux + a
        return x, aux

    def fwd(p, x, positions, mode, cache=None, cache_len=None):
        """-> (final-normed x, the MoE layers' summed aux loss); in decode
        each sub-layer's cache is written in place. In training each
        super-block runs under ``_maybe_remat``, as the reference's scan
        body does."""
        body = _maybe_remat(super_block, cfg, mode)
        aux = 0.0
        for j, pb in enumerate(_unstack(p["blocks"], n_sb)):
            cb = _layer(cache, j) if cache is not None else None
            x, a = body(pb, x, positions, cb, cache_len)
            aux = aux + a
        x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, aux

    def loss_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, aux = fwd(p, x, _positions(B, S, x.device), "train")
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        aux = _aux(aux, ce)
        loss = ce + AUX_WEIGHT * aux / cfg.num_layers
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, _ = fwd(p, x, _positions(B, S, x.device), "prefill")
        # the serve path fills the caches by replaying the prompt through
        # decode, as the reference's does
        logits = _logits(cfg, p, x[:, -1:], sh)
        return logits, {"len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        B = batch["token"].shape[0]
        pos = cache["len"]
        x = _embed(cfg, p, batch["token"], sh)
        positions = pos.reshape(1, 1).expand(B, 1)
        x, _ = fwd(p, x, positions, "decode", cache=cache["blocks"],
                   cache_len=pos)
        logits = _logits(cfg, p, x, sh)
        return logits, {"blocks": cache["blocks"], "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        sb = {}
        for i, (attn_kind, _) in enumerate(kinds):
            W = cache_len if attn_kind == "full" else min(
                cfg.chunked_local, cache_len)
            sb[f"sub{i}"] = T.attn_cache_defs(
                cfg, batch, W, long and attn_kind == "full")
        return {"blocks": stack_specs(sb, n_sb), "len": _len_def()}

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, functools.partial(_base_batch_defs, cfg))


# ---------------------------------------------------------------------------
# family: griffin / recurrentgemma (rec,rec,attn triples + remainder)
# ---------------------------------------------------------------------------

def _griffin(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    pat = cfg.block_pattern                                # ("rec","rec","attn")
    n_tri = cfg.num_layers // len(pat)
    n_tail = cfg.num_layers - n_tri * len(pat)

    def sub_defs(kind):
        mix = G.rec_defs(cfg) if kind == "rec" else T.attn_defs(cfg)
        return {"mix": mix, "mlp": T.mlp_defs(cfg)}

    tri_defs = {f"sub{i}": sub_defs(kind) for i, kind in enumerate(pat)}
    defs = {**_embed_defs(cfg), "tri": stack_specs(tri_defs, n_tri)}
    for t in range(n_tail):
        defs[f"tail{t}"] = sub_defs("rec")

    def _sub_apply(kind, pl, x, positions, c, cache_len):
        if kind == "rec":
            x, _ = G.rec_apply(cfg, pl["mix"], x, sh, cache=c)
        else:
            x, _ = T.attn_apply(cfg, pl["mix"], x, sh, positions=positions,
                                layer_kind="window", cache=c,
                                cache_len=cache_len)
        return T.mlp_apply(cfg, pl["mlp"], x, sh)

    def triple(pb, x, positions, cb, cache_len):
        for i, kind in enumerate(pat):
            x = _sub_apply(kind, pb[f"sub{i}"], x, positions,
                           cb[f"sub{i}"] if cb else None, cache_len)
        return x

    def fwd(p, x, positions, mode, cache=None, cache_len=None):
        """-> final-normed x; in decode every layer's cache is written in
        place. In training each (rec, rec, attn) triple runs under
        ``_maybe_remat`` and the remainder layers do not, as in the
        reference."""
        body = _maybe_remat(triple, cfg, mode)
        for j, pb in enumerate(_unstack(p["tri"], n_tri)):
            cb = _layer(cache["tri"], j) if cache is not None else None
            x = body(pb, x, positions, cb, cache_len)
        for t in range(n_tail):
            x = _sub_apply("rec", p[f"tail{t}"], x, positions,
                           cache[f"tail{t}"] if cache is not None else None,
                           cache_len)
        return apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)

    def loss_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x = fwd(p, x, _positions(B, S, x.device), "train")
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        return ce, {"loss": ce, "ce": ce}

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x = fwd(p, x, _positions(B, S, x.device), "prefill")
        logits = _logits(cfg, p, x[:, -1:], sh)
        return logits, {"len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        B = batch["token"].shape[0]
        pos = cache["len"]
        x = _embed(cfg, p, batch["token"], sh)
        positions = pos.reshape(1, 1).expand(B, 1)
        x = fwd(p, x, positions, "decode", cache=cache, cache_len=pos)
        logits = _logits(cfg, p, x, sh)
        return logits, {**cache, "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        tri = {}
        for i, kind in enumerate(pat):
            if kind == "rec":
                tri[f"sub{i}"] = G.rec_cache_defs(cfg, batch)
            else:
                W = min(cfg.window, cache_len)
                tri[f"sub{i}"] = T.attn_cache_defs(cfg, batch, W)
        out = {"tri": stack_specs(tri, n_tri), "len": _len_def()}
        for t in range(n_tail):
            out[f"tail{t}"] = G.rec_cache_defs(cfg, batch)
        return out

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, functools.partial(_base_batch_defs, cfg))


# ---------------------------------------------------------------------------
# family: granite-4.0-h (hybrid_moe: Mamba-2 / NoPE GQA mixers, MoE each)
# ---------------------------------------------------------------------------

MIXERS = ("mamba", "attention")


def layer_kinds(cfg) -> tuple[str, ...]:
    """Each layer's mixer, "mamba" or "attention": the first
    ``num_layers`` of ``cfg.layer_types`` (a cut in depth keeps the first
    layers, as a pipeline's first stage holds them)."""
    kinds = tuple(cfg.layer_types[:cfg.num_layers])
    if len(kinds) < cfg.num_layers or set(kinds) - set(MIXERS):
        raise ValueError(f"{cfg.name}: want {cfg.num_layers} layer types "
                         f"among {MIXERS}; got {cfg.layer_types}")
    return kinds


def _granite(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    """Each layer: x + r·mixer(rms(x)), the mixer Mamba-2 or attention as
    ``layer_kinds`` says, then x + r·(moe(rms(x)) + shared(rms(x))), r
    the ``residual_multiplier`` (``moe_apply`` adds the shared expert).
    The embedding's output is multiplied by ``embedding_multiplier``, the
    logits divided by ``logits_scaling``; attention has no positional
    embedding (``rope_theta`` 0) and its softmax scale is
    ``attention_multiplier``. Parameters are stacked by kind: "mamba" and
    "attn" over the layers of each mixer, "moe" over every layer, in
    layer order. The prefill hands off each layer's cache, in layer order:
    a Mamba layer's {"conv", "ssm"} (the conv's last inputs, SSD's final
    state, f32) and an attention layer's {"k", "v"} [B, S, Hkv, hd]."""
    sh = Sharder(mesh, rules)
    kinds = layer_kinds(cfg)
    n_kind = {k: kinds.count(k) for k in MIXERS}
    defs = {**_embed_defs(cfg),
            "moe": stack_specs(moe_defs(cfg), cfg.num_layers)}
    if n_kind["mamba"]:
        defs["mamba"] = stack_specs(M.mamba_defs(cfg), n_kind["mamba"])
    if n_kind["attention"]:
        defs["attn"] = stack_specs(T.attn_defs(cfg), n_kind["attention"])

    def mamba_layer(pm, pe, x, cl):
        x, c = M.mamba_apply(cfg, pm, x, sh, cache=cl)
        x, aux = moe_apply(cfg, pe, x, sh)
        return x, c, aux

    def attn_layer(pa, pe, x, cl, cache_len):
        x, c = T.attn_apply(cfg, pa, x, sh, positions=None, cache=cl,
                            cache_len=cache_len)
        x, aux = moe_apply(cfg, pe, x, sh)
        return x, c, aux

    def embed(p, tokens):
        x = _embed(cfg, p, tokens, sh)
        if cfg.embedding_multiplier != 1:
            x = x * cfg.embedding_multiplier
        return x

    def head_input(x):
        return x if cfg.logits_scaling == 1 else x / cfg.logits_scaling

    def fwd(p, x, mode, cache=None, cache_len=None):
        """-> (final-normed x, the layers' summed aux loss, each layer's
        cache: the prefill's handoff or, in decode, the updated caches,
        an attention layer's written in place). In training each layer
        runs under ``_maybe_remat``."""
        mixers = {"mamba": _unstack(p["mamba"], n_kind["mamba"])
                  if n_kind["mamba"] else [],
                  "attention": _unstack(p["attn"], n_kind["attention"])
                  if n_kind["attention"] else []}
        bodies = {"mamba": _maybe_remat(mamba_layer, cfg, mode),
                  "attention": _maybe_remat(attn_layer, cfg, mode)}
        seen = {k: 0 for k in MIXERS}
        caches, aux = [], 0.0
        for i, pe in enumerate(_unstack(p["moe"], cfg.num_layers)):
            kind = kinds[i]
            pm = mixers[kind][seen[kind]]
            seen[kind] += 1
            cl = cache[i] if cache is not None else None
            if kind == "mamba":
                x, c, a = bodies[kind](pm, pe, x, cl)
                if cl is None:
                    # the conv tail is a view of the conv's whole input: a
                    # copy keeps only it, for the prefill's handoff
                    c = {"conv": c["conv"].clone(), "ssm": c["ssm"]} \
                        if mode == "prefill" else None
            else:
                x, c, a = bodies[kind](pm, pe, x, cl, cache_len)
            caches.append(c)
            aux = aux + a
        with span("model.norm"):
            x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, aux, caches

    def loss_fn(p, batch):
        x = embed(p, batch["tokens"])
        x, aux, _ = fwd(p, x, "train")
        ce = _lm_loss(cfg, p, head_input(x), batch["targets"],
                      batch["mask"], sh)
        aux = _aux(aux, ce)
        loss = ce + AUX_WEIGHT * aux / cfg.num_layers
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill_fn(p, batch):
        """-> (the last position's logits, the handoff): {"layers": each
        layer's cache, "len"}. While a profiler records, counts the bytes
        handed off of each kind (``ssm.state_bytes``, ``attn.kv_bytes``)."""
        S = batch["tokens"].shape[1]
        x = embed(p, batch["tokens"])
        x, _, caches = fwd(p, x, "prefill")
        with span("model.head"):
            logits = _logits(cfg, p, head_input(x[:, -1:]), sh)
        with span("model.cache"):
            if recording():
                for kind, name in (("mamba", "ssm.state_bytes"),
                                   ("attention", "attn.kv_bytes")):
                    count(name, sum(t.numel() * t.element_size()
                                    for k, c in zip(kinds, caches)
                                    if k == kind for t in c.values()))
            return logits, {"layers": caches, "len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        """One token at ``cache["len"]``: each Mamba layer's state
        advanced (new tensors), each attention layer's k/v written in
        place at slot ``len``, so an attention cache holds more slots
        than ``len`` (the decode tier places the prefill's handoff in the
        first S of its own). -> (logits, the caches with ``len`` + 1)."""
        pos = cache["len"]
        x = embed(p, batch["token"])
        x, _, caches = fwd(p, x, "decode", cache=cache["layers"],
                           cache_len=pos)
        logits = _logits(cfg, p, head_input(x), sh)
        return logits, {"layers": caches, "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        return {"layers": [M.mamba_cache_defs(cfg, batch) if k == "mamba"
                           else T.attn_cache_defs(cfg, batch, cache_len,
                                                  long) for k in kinds],
                "len": _len_def()}

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, functools.partial(_base_batch_defs, cfg))


# ---------------------------------------------------------------------------
# family: whisper (enc-dec; frame embeddings provided by the stub frontend)
# ---------------------------------------------------------------------------

WHISPER_MAX_DEC = 32768


def _rows(table, n: int, sh):
    """The first ``n`` rows of a position table, laid out as the table (so
    that on a mesh their gradient is reduced at their size, then padded
    to the table's)."""
    return sh(table[:n], None, "embed")


def _whisper(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    enc_layer = {"attn": T.attn_defs(cfg), "mlp": T.mlp_defs(cfg)}
    dec_layer = {"self": T.attn_defs(cfg), "cross": T.attn_defs(cfg),
                 "mlp": T.mlp_defs(cfg)}
    defs = {**_embed_defs(cfg),
            "enc_pos": ParamSpec((cfg.encoder_seq, cfg.d_model),
                                 (None, "embed"), init="small"),
            "dec_pos": ParamSpec((WHISPER_MAX_DEC, cfg.d_model),
                                 (None, "embed"), init="small"),
            "enc_ln": norm_defs(cfg.norm_kind, cfg.d_model),
            "enc": [enc_layer for _ in range(cfg.encoder_layers)],
            "dec": [dec_layer for _ in range(cfg.num_layers)]}

    # the reference checkpoints each whisper layer whole in training,
    # whatever ``remat`` other than "none" says
    remat_cfg = cfg.replace(remat="full") if cfg.remat != "none" else cfg

    def enc_layer(lp, x, pos):
        x, _ = T.attn_apply(cfg, lp["attn"], x, sh, positions=pos,
                            layer_kind="bidir")
        return T.mlp_apply(cfg, lp["mlp"], x, sh)

    def encode(p, frames, mode="decode"):
        """frames [B,Senc,d] -> the encoder output [B,Senc,d]: learned
        positions, bidirectional self attention and the MLP a layer."""
        x = frames.to(cfg.compute_dtype)
        x = x + _rows(p["enc_pos"], x.shape[1], sh).to(x.dtype)[None]
        pos = _positions(x.shape[0], x.shape[1], x.device)
        body = _maybe_remat(enc_layer, remat_cfg, mode)
        for lp in p["enc"]:
            x = body(lp, x, pos)
        return apply_norm(cfg.norm_kind, p["enc_ln"], x, cfg.norm_eps)

    def dec_layer(lp, x, enc_out, positions, c, cache_len):
        x, _ = T.attn_apply(cfg, lp["self"], x, sh, positions=positions,
                            layer_kind="full", cache=c, cache_len=cache_len)
        x, _ = T.attn_apply(cfg, lp["cross"], x, sh, positions=positions,
                            layer_kind="cross", kv_override=enc_out)
        return T.mlp_apply(cfg, lp["mlp"], x, sh)

    def decode_stack(p, x, enc_out, positions, cache=None, cache_len=None,
                     mode="decode"):
        """Causal self attention (decode: against ``cache``, written in
        place), cross attention to ``enc_out``, then the MLP, a layer."""
        body = _maybe_remat(dec_layer, remat_cfg, mode)
        for li, lp in enumerate(p["dec"]):
            c = cache[li] if cache is not None else None
            x = body(lp, x, enc_out, positions, c, cache_len)
        return apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)

    def loss_fn(p, batch):
        enc_out = encode(p, batch["frames"], mode="train")
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x = x + _rows(p["dec_pos"], S, sh).to(x.dtype)[None]
        x = decode_stack(p, x, enc_out, _positions(B, S, x.device),
                         mode="train")
        ce = _lm_loss(cfg, p, x, batch["targets"], batch["mask"], sh)
        return ce, {"loss": ce, "ce": ce}

    def prefill_fn(p, batch):
        enc_out = encode(p, batch["frames"])
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x = x + _rows(p["dec_pos"], S, sh).to(x.dtype)[None]
        x = decode_stack(p, x, enc_out, _positions(B, S, x.device))
        logits = _logits(cfg, p, x[:, -1:], sh)
        return logits, {"len": _len(S, x.device)}

    def decode_fn(p, cache, batch):
        """One token at ``cache["len"]``. The frames are encoded again at
        every step, as the reference does (the encoder output is not
        cached)."""
        B = batch["token"].shape[0]
        pos = cache["len"]
        enc_out = encode(p, batch["frames"])
        x = _embed(cfg, p, batch["token"], sh)
        x = x + p["dec_pos"].index_select(
            0, pos.reshape(1).long()).to(x.dtype)[None]
        positions = pos.reshape(1, 1).expand(B, 1)
        x = decode_stack(p, x, enc_out, positions, cache=cache["dec"],
                         cache_len=pos)
        logits = _logits(cfg, p, x, sh)
        return logits, {"dec": cache["dec"], "len": pos + 1}

    def cache_defs(batch, cache_len, long=False):
        one = T.attn_cache_defs(cfg, batch, cache_len)
        return {"dec": [one for _ in range(cfg.num_layers)],
                "len": _len_def()}

    def batch_defs(shape: ShapeConfig):
        b = _base_batch_defs(cfg, shape)
        b["frames"] = ParamSpec(
            (shape.global_batch, cfg.encoder_seq, cfg.d_model),
            ("batch", "seq", "act_embed"), "zeros", cfg.compute_dtype)
        return b

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn,
                       cache_defs, batch_defs, encode)


# ---------------------------------------------------------------------------

def _apply_param_dtype(defs, dtype):
    """In-place: weight matrices (ndim>=2) take cfg.param_dtype; 1D scales,
    biases and integer leaves stay as declared. In-place so the family
    closures (which captured the same containers) see the change."""
    if isinstance(defs, dict):
        for k, v in defs.items():
            if isinstance(v, ParamSpec):
                if len(v.shape) >= 2 and v.dtype == torch.float32:
                    defs[k] = dataclasses.replace(v, dtype=dtype)
            else:
                _apply_param_dtype(v, dtype)
    elif isinstance(defs, (list, tuple)):
        for v in defs:
            _apply_param_dtype(v, dtype)


# the builder of each family; the rest are homogeneous decoder LMs, as in
# the reference
_FAMILIES = {"ssm": _mamba, "hybrid": _griffin, "hybrid_moe": _granite,
             "audio": _whisper}


def build_model(cfg: ModelConfig, mesh=None, rules=None) -> ModelBundle:
    if cfg.family == "moe":
        family = _deepseek if cfg.attn_kind == "mla" else _llama4
    else:
        family = _FAMILIES.get(cfg.family, _decoder_lm)
    b = family(cfg, rules, mesh)
    if cfg.param_dtype != torch.float32:
        _apply_param_dtype(b.param_defs, cfg.param_dtype)
    return b


# leaves the Mamba-2 block reads in f32 whatever the compute dtype
# (mamba2.py: dt_bias and A_log feed softplus and exp in f32)
_F32_AT_USE = ("A_log", "dt_bias")
# a LayerNorm's scale and bias are read in f32 too (modules.layer_norm);
# an RMSNorm's scale is cast to the activations' dtype, like every weight
_LN_F32_AT_USE = ("scale", "bias")


def cast_params(cfg: ModelConfig, params):
    """The parameter tree as the forward pass reads it: every floating leaf
    in ``cfg.compute_dtype`` but those the model reads in f32
    (``_F32_AT_USE``, and ``_LN_F32_AT_USE`` where the norms are
    LayerNorms), as a new tree (``params`` is left as it was). The model
    casts each weight to the compute dtype at every use, as the reference
    does (``.to(h.dtype)``); casting once here makes those casts no-ops,
    with identical numbers, and keeps decode from re-reading the f32
    weights at every token."""
    return cast_params_(cfg, tree_map(lambda t: t, params,
                                      is_leaf=torch.is_tensor))


def cast_params_(cfg: ModelConfig, params):
    """``cast_params`` in place, leaf by leaf: each leaf of the tree
    ``params`` (dicts and lists) is replaced by its cast before the next
    one is cast, so the old leaf is freed at once where the caller holds no
    other reference to it. A tree drawn in f32 on the card then never
    needs more than its f32 size plus its largest leaf in the compute
    dtype, where ``cast_params`` holds both trees whole. -> ``params``."""
    keep = _F32_AT_USE + (_LN_F32_AT_USE if cfg.norm_kind == "ln" else ())
    keys = range(len(params)) if isinstance(params, list) else list(params)
    for k in keys:
        v = params[k]
        if isinstance(v, (dict, list)):
            cast_params_(cfg, v)
        elif k not in keep and v.is_floating_point():
            params[k] = v.to(cfg.compute_dtype)
        del v
    return params
