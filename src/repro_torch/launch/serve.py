"""Serving entry point: prefill a batch of prompts, then batched greedy decode
(PyTorch port of ``repro.launch.serve``), on a torch device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --smoke --prompt-len 16 --new-tokens 8 --batch 2 [--device cuda|cpu]

``--arch`` defaults to smollm-135m, as in the reference, and takes every
registered arch. ``--device`` defaults to cuda and raises without a card.
Weights are random, drawn from ``--seed`` (in f32 where the config
declares f32 parameters) and cast in place to the compute dtype before
serving (``cast_params_``), so the card holds one copy of them; so are the
prompts and whisper's frames (numpy, as the reference draws them). A
vlm's vision embeddings and mrope positions are zeros, as the reference's
serve makes them. Whisper's frames go with the prefill and with every
decode step, which encodes them again, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, get_config,
                                      registry)
from repro_torch.configs.smoke import smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import build_model, cast_params, cast_params_
from repro_torch.models.modules import init_params, tree_map


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # [B, new_tokens] int32, greedy
    prefill_logits: torch.Tensor  # [B, 1, V] the prefill's last position
    replay_logits: torch.Tensor   # [B, 1, V] decode's at the last prompt token
    prefill_s: float              # wall seconds of the prefill
    decode_s: float               # wall seconds of the decode loop
    decode_steps: int             # prompt replay + generation steps


@dataclasses.dataclass(frozen=True)
class ServeCell:
    arch: str
    batch: int = 4
    prompt: int = 512
    new: int = 32
    seed: int = 0
    layers: int | None = None     # a cut of the depth; None: the config's

    def config(self) -> ModelConfig:
        """The arch's published config at full width, cut to ``layers``."""
        cfg = get_config(self.arch)
        return cfg if self.layers is None else cfg.replace(
            num_layers=self.layers)


# The serve cells: what chip_smoke.py serves and launch/profile_serve.py
# traces. Each arch at full width, 4 prompts of 512 tokens (whisper: 64
# decoder tokens after 1500 frames), 32 new tokens, weights and prompts
# from seed 0, at full depth but llama4's: 4 of its 48 layers (one
# super-block), as 48 layers of 400 B parameters do not fit one card.
CELLS = {c.arch: c for c in (ServeCell("mamba2-2.7b"),
                              ServeCell("glm4-9b"),
                              ServeCell("deepseek-v2-lite-16b"),
                              ServeCell("recurrentgemma-9b"),
                              ServeCell("whisper-tiny", prompt=64),
                              ServeCell("llama4-maverick-400b-a17b",
                                        layers=4))}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def random_request(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                   device=None):
    """-> (params, tokens, frames): random weights from ``init_params``
    with a torch generator on ``device`` seeded with ``seed``; prompts
    [batch, prompt_len] int32 on the CPU from numpy seeded the same, and
    after them from the same generator, for an encoder-decoder (whisper),
    the frames [batch, encoder_seq, d_model] f32 on the CPU as standard
    normals (else None): the reference's serve draws both so."""
    dev = resolve_device(device)
    params = init_params(build_model(cfg).param_defs,
                         torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32))
    frames = None
    if cfg.encoder_layers:
        frames = torch.from_numpy(rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return params, tokens, frames


def decode_loop(decode, params, cache, tokens: torch.Tensor,
                new_tokens: int, frames: torch.Tensor | None = None):
    """The reference's decode loop: replay ``tokens`` [B, S] through the
    decode step ``decode`` into ``cache``, then ``new_tokens`` greedy
    tokens; S + new_tokens - 1 steps, each given ``frames`` too where
    there are any. -> (generated [B, new_tokens] int32, the logits at the
    last prompt token)."""
    B, S = tokens.shape
    token = tokens[:, :1]
    extra = {} if frames is None else {"frames": frames}
    toks, replay = [], None
    for t in range(S + new_tokens - 1):
        if t < S:
            token = tokens[:, t:t + 1]
        lg, cache = decode(params, cache, {"token": token, **extra})
        nxt = torch.argmax(lg[:, 0, :], dim=-1).to(torch.int32)[:, None]
        if t == S - 1:
            replay = lg
        if t >= S - 1:
            toks.append(nxt[:, 0])
            token = nxt
    gen = torch.stack(toks, 1) if toks else \
        torch.zeros((B, 0), dtype=torch.int32, device=tokens.device)
    return gen, replay


def prefill_batch(bundle, tokens: torch.Tensor,
                  frames: torch.Tensor | None = None) -> dict:
    """The prefill's inputs for ``tokens`` [B, S]: the bundle's batch defs
    made as the reference's serve makes them (a vlm's vision embeddings
    and mrope positions are zeros), with the tokens in place and, for an
    encoder-decoder, ``frames`` cast to the batch's dtype on its
    device."""
    B, S = tokens.shape
    batch = init_params(bundle.batch_defs(ShapeConfig("serve", S, B,
                                                      "prefill")),
                        None, tokens.device)
    batch["tokens"] = tokens
    if "frames" in batch:
        batch["frames"] = frames.to(batch["frames"])
    return batch


def generate(cfg: ModelConfig, params, tokens: torch.Tensor, new_tokens: int,
             device=None, frames: torch.Tensor | None = None) -> Generation:
    """Prefill ``tokens`` [B, S] int32 (with ``frames`` for an
    encoder-decoder), then decode greedily as the reference's loop does: a
    fresh cache sized for the whole generation, the prompt replayed
    through decode, then ``new_tokens`` greedy tokens. Weights are cast to
    the compute dtype once (``cast_params``): a copy of the tree, unless
    the caller cast it already (``cast_params_``, in place)."""
    dev = resolve_device(device)
    bundle = build_model(cfg)
    params = cast_params(cfg, tree_map(lambda t: t.to(dev), params))
    tokens = tokens.to(device=dev, dtype=torch.int32)
    B, S = tokens.shape
    prefill = make_prefill_step(bundle)
    batch = prefill_batch(bundle, tokens, frames)

    _sync(dev)
    t0 = time.perf_counter()
    logits, _ = prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    # a fresh cache sized for the full generation (prefill replayed into
    # it), passed without a name here so that each step's update frees the
    # cache before it
    decode = make_decode_step(bundle)
    cache_defs = bundle.cache_defs(B, S + new_tokens)
    t0 = time.perf_counter()
    gen, replay = decode_loop(decode, params,
                              init_params(cache_defs, None, dev), tokens,
                              new_tokens, batch.get("frames"))
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return Generation(gen, logits, replay, prefill_s, decode_s,
                      max(S + new_tokens - 1, 0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(registry()))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params, tokens, frames = random_request(cfg, args.batch,
                                            args.prompt_len, args.seed, dev)
    cast_params_(cfg, params)            # one copy of the weights, cast

    out = generate(cfg, params, tokens, args.new_tokens, dev, frames)
    print(f"{cfg.name}: generated {out.tokens.shape[1]} tokens/seq on {dev} "
          f"(prefill {out.prefill_s:.3f} s, decode {out.decode_s:.3f} s "
          f"over {out.decode_steps} steps)")
    for b in range(args.batch):
        print(f"  seq{b}: {out.tokens[b].tolist()}")


if __name__ == "__main__":
    main()
