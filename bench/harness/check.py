"""Whether what the timed path produced is right: after the window, a
sample of the finished requests, drawn from the seed with one of the
longest in it, goes through the plain reference of the configuration's
family in float32, fed the same weights and prompts. Two numbers are
compared, each with its limit from ``bench/checks/<cell>.json``:

  logit_err  the largest relative L2 distance, over the sample, between a
             request's last-position logits as the prefill returned them
             and the reference's;
  token_gap  the widest gap by which the logit of the first token the
             pool served (the argmax it sent back) lies below the
             reference's best logit;
  logit_err_median  the median of logit_err over the sample.

A cell's check file names the numbers it compares; the others are not
judged.
"""
from __future__ import annotations

import random

import torch

# prompt tokens the reference reads in one run, and at once
SAMPLE_TOKENS = 32768
BLOCK_TOKENS = 16384


def sample(requests: list[tuple[int, int, int]], seed: int
           ) -> list[tuple[int, int, int]]:
    """(batch, row, length) of the requests to check: one of the longest,
    then others in an order drawn from ``seed`` while they fit in
    SAMPLE_TOKENS."""
    rng = random.Random(seed)
    top = max(s for _, _, s in requests)
    longest = [r for r in requests if r[2] == top]
    first = longest[rng.randrange(len(longest))]
    rest = [r for r in requests if r != first]
    rng.shuffle(rest)
    out, used = [first], first[2]
    for r in rest:
        if used + r[2] <= SAMPLE_TOKENS:
            out.append(r)
            used += r[2]
    return sorted(out)


def reference_logits(ref, weights: dict, conf: dict,
                     prompts: list[torch.Tensor], prec) -> torch.Tensor:
    """The reference's last-position logits [n, V] of ``prompts`` (1-D
    token tensors), prompts of one length in blocks."""
    out = [None] * len(prompts)
    by_len: dict[int, list[int]] = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(p.numel(), []).append(i)
    for S, idx in sorted(by_len.items()):
        per = max(1, BLOCK_TOKENS // S)
        for a in range(0, len(idx), per):
            part = idx[a:a + per]
            with torch.no_grad():
                lg = ref.forward(weights, conf,
                                 torch.stack([prompts[i] for i in part]),
                                 prec)
            for i, row in zip(part, lg):
                out[i] = row
    return torch.stack(out)


def numbers(logits: torch.Tensor, served: torch.Tensor,
            ref: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per request: the relative L2 distance of ``logits`` [n, V] from
    ``ref`` [n, V], and the gap of the served token's reference logit
    below the reference's best."""
    logits, ref = logits.float(), ref.float()
    err = (logits - ref).norm(dim=-1) / ref.norm(dim=-1)
    gap = ref.max(-1).values - ref.gather(
        -1, served.long().view(-1, 1).to(ref.device))[:, 0]
    return {"logit_err": err, "token_gap": gap}


def reduce(per_request: dict) -> dict[str, float]:
    """The sample's numbers from the per-request ones."""
    return {"logit_err": float(per_request["logit_err"].max()),
            "logit_err_median": float(per_request["logit_err"].median()),
            "token_gap": float(per_request["token_gap"].max())}


def judge(per_request: dict, limits: dict | None) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}} for each number the limits
    name); with no limits, not correct and every number shown. A number
    that is not finite fails."""
    vals = reduce(per_request)
    if not limits:
        return False, {k: {"value": v, "limit": None}
                       for k, v in vals.items()}
    out, ok = {}, True
    for name, lim in limits.items():
        v = vals[name]
        out[name] = {"value": v, "limit": lim}
        ok = ok and v == v and v <= lim
    return ok, out
