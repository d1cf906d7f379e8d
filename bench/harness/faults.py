"""Faults a prefill pool can have, each a wrapper of the prefill step
that breaks its timed path underneath: the output check must find each
(``calibrate.py --fault`` on the card, ``tests/test_bench_faults.py`` at
smoke width). A prefill keeps no state between batches and every cell
runs on one chip, so a state left unchanged and a missing exchange
between chips do not apply."""
from __future__ import annotations

import torch


def answer_altered(step):
    """The first request of every batch gets its answer negated where the
    prefill produces it."""
    def f(params, batch):
        lg, cache = step(params, batch)
        lg = lg.clone()
        lg[0] = -lg[0]
        return lg, cache
    return f


def half_batch_left_out(step):
    """Only the first half of every batch is computed; the other half
    gets its answers."""
    def f(params, batch):
        t = batch["tokens"]
        half = max(1, t.shape[0] // 2)
        lg, cache = step(params, dict(batch, tokens=t[:half]))
        return torch.cat([lg] * (t.shape[0] // half + 1))[:t.shape[0]], cache
    return f


FAULTS = {"answer_altered": answer_altered,
          "half_batch_left_out": half_batch_left_out}
