"""The one traffic generator: a mix file (``bench/traffic/<mix>.json``)
gives a closed-loop prefill pool's parameters, and this turns them into
batches. Each batch holds requests of one prompt length, as many as fill
``batch_tokens``; the lengths follow ``cycle`` in order, again and again.
So a run's work does not depend on the seed, which draws only the token
ids, uniform over the vocabulary (``tokens.dist`` "uniform", the one
distribution generated)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch


@dataclasses.dataclass(frozen=True)
class Batch:
    seq: int                  # prompt length of every request in it
    rows: int                 # requests


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("loop") != "closed":
        raise ValueError(f"{path}: only closed-loop pools are generated")
    for s in mix["cycle"]:
        if not 0 < s <= mix["batch_tokens"]:
            raise ValueError(f"{path}: length {s} outside one batch")
    dist = mix.get("tokens", {"dist": "uniform"})["dist"]
    if dist != "uniform":
        raise ValueError(f"{path}: unknown token distribution {dist!r}")
    return mix


def cycle(mix: dict) -> list[Batch]:
    """One turn of the cycle: a batch a prompt length, in order."""
    return [Batch(s, mix["batch_tokens"] // s) for s in mix["cycle"]]


def batch_at(mix: dict, i: int) -> Batch:
    """The i-th batch the pool dispatches (from 0)."""
    c = cycle(mix)
    return c[i % len(c)]


def token_pool(mix: dict, vocab: int, rows: int, seed: int, device
               ) -> torch.Tensor:
    """[rows, batch_tokens] int32 token ids drawn from ``seed`` on
    ``device``; the i-th batch reads row i % rows (its first B x S ids)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (rows, mix["batch_tokens"]),
                         generator=gen, device=device).to(torch.int32)
