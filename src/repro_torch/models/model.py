"""Model assembly: config -> ModelBundle (prefill / decode + defs), PyTorch
port of ``repro.models.model``.

A bundle is everything launch/ needs:
  param_defs            ParamSpec tree (init, counts)
  loss_fn(p, batch)     -> (loss, metrics)          [train; not ported yet]
  prefill_fn(p, batch)  -> (last_logits, cache)
  decode_fn(p, cache, batch) -> (logits, cache)
  cache_defs(batch, cache_len, long) -> ParamSpec tree (+ "len" scalar)
  batch_defs(shape)     -> ParamSpec tree of inputs

Layers are stacked on a leading "layers" dim as in the reference; its
``jax.lax.scan`` over that dim is a Python loop here. The port has the
``ssm`` family (Mamba-2); the others raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import mamba2 as M
from repro_torch.models.modules import (ParamSpec, Sharder, apply_norm,
                                        norm_defs, stack_specs, tree_map)


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    param_defs: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_defs: Callable
    batch_defs: Callable


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
    x = p["embed"][tokens].to(cfg.compute_dtype)
    return sh(x, "batch", "seq", "act_embed")


def _head(cfg, p):
    if cfg.tie_embeddings:
        return p["embed"].T
    return p["lm_head"]


def _logits(cfg, p, h, sh):
    out = h @ _head(cfg, p).to(h.dtype)
    out = sh(out, "batch", None, "act_heads")
    return out[..., :cfg.vocab_size]          # drop vocab padding (serving)


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


def _layer(stacked, i: int):
    """Layer ``i`` of a tree stacked on a leading "layers" dim (views)."""
    return tree_map(lambda t: t[i], stacked)


def _stack(layers: list):
    """Per-layer trees -> one tree stacked on a new leading dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers]) for k in first}
    return torch.stack(layers)


# ---------------------------------------------------------------------------
# family: mamba2
# ---------------------------------------------------------------------------

def _mamba(cfg: ModelConfig, rules=None, mesh=None) -> ModelBundle:
    sh = Sharder(mesh, rules)
    defs = {**_embed_defs(cfg),
            "layers": stack_specs(M.mamba_defs(cfg), cfg.num_layers)}

    def fwd(p, x, mode, cache=None):
        ncs = []
        for i in range(cfg.num_layers):
            cl = _layer(cache, i) if cache is not None else None
            x, nc = M.mamba_apply(cfg, _layer(p["layers"], i), x, sh,
                                  cache=cl)
            ncs.append(nc)
        x = apply_norm(cfg.norm_kind, p["final_ln"], x, cfg.norm_eps)
        return x, (_stack(ncs) if cache is not None else None)

    def loss_fn(p, batch):
        raise NotImplementedError("training is not ported yet "
                                  "(ROADMAP A5/A6)")

    def prefill_fn(p, batch):
        B, S = batch["tokens"].shape
        x = _embed(cfg, p, batch["tokens"], sh)
        x, _ = fwd(p, x, "prefill")
        logits = _logits(cfg, p, x[:, -1:], sh)
        return logits, {"len": torch.tensor(S, dtype=torch.int32,
                                            device=x.device)}

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

    return ModelBundle(cfg, defs, loss_fn, prefill_fn, decode_fn, cache_defs,
                       functools.partial(_base_batch_defs, cfg))


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


# ROADMAP items of the families the port does not have yet
_NOT_PORTED = {"dense": "A4", "vlm": "A4", "moe": "A7", "hybrid": "A8",
               "audio": "A8"}


def build_model(cfg: ModelConfig, mesh=None, rules=None) -> ModelBundle:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP "
            f"{_NOT_PORTED.get(cfg.family, 'Queue A')})")
    b = _mamba(cfg, rules, mesh)
    if cfg.param_dtype != torch.float32:
        _apply_param_dtype(b.param_defs, cfg.param_dtype)
    return b


# leaves the Mamba-2 block reads in f32 whatever the compute dtype
# (mamba2.py: dt_bias and A_log feed softplus and exp in f32)
_F32_AT_USE = ("A_log", "dt_bias")


def cast_params(cfg: ModelConfig, params):
    """The parameter tree as the forward pass reads it: every floating leaf
    but ``_F32_AT_USE`` in ``cfg.compute_dtype``. The model casts each
    weight to the compute dtype at every use, as the reference does
    (mamba2.py ``.to(h.dtype)``); casting once here makes those casts
    no-ops, with identical numbers, and keeps decode from re-reading the
    f32 weights at every token."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if key in _F32_AT_USE or not t.is_floating_point():
            return t
        return t.to(cfg.compute_dtype)
    return walk(params)
