"""The port's spans and counters (``repro_torch/obs/spans.py``): a prefill
under a CPU profiler marks each span of the model code once where it
should, inside its parent on one thread; outside a profiler ``span`` is
the shared null context and calls nothing of torch's profiler, and no
counter moves; the results are the same bits with the profiler on or
off; and ``moe.kept`` counts what the plain ``dispatch_indices`` keeps."""
import dataclasses
import unittest.mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.smoke import smoke_config
from repro_torch.launch import serve, steps
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.models.modules import Sharder, apply_norm, tree_map
from repro_torch.obs import spans

ARCHS = ["glm4-9b", "deepseek-v2-lite-16b"]
B, S = 2, 32

# spans a smoke prefill marks: glm4-9b 3 dense layers; deepseek-v2-lite 3
# MLA layers (norm and kv_ln; rope of q, of k, and the q/k concatenations),
# the first dense, then 2 MoE (act of the experts and of the shared ones)
WANT = {
    "glm4-9b": {"model.prefill": 1, "model.attn": 3, "model.attn.norm": 3,
                "model.attn.rope": 3, "model.ffn": 3, "model.ffn.norm": 3,
                "model.ffn.act": 3, "model.norm": 1, "model.head": 1,
                "model.cache": 1},
    "deepseek-v2-lite-16b": {
        "model.prefill": 1, "model.attn": 3, "model.attn.norm": 6,
        "model.attn.rope": 9, "model.ffn": 3, "model.ffn.norm": 3,
        "model.ffn.act": 5, "model.ffn.dispatch": 2,
        "model.ffn.combine": 2, "model.norm": 1, "model.head": 1,
        "model.cache": 1},
}


def parent_of(name: str) -> str:
    if name == "model.prefill":
        return None
    if name.count(".") == 2:
        return name.rsplit(".", 1)[0]
    return "model.prefill"


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = smoke_config(request.param)
    bundle = build_model(cfg)
    params, tokens, _ = serve.random_request(cfg, B, S, 7, "cpu")
    batch = serve.prefill_batch(bundle, tokens)
    spans.counters()
    return request.param, cfg, bundle, params, batch


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("model.")]


def test_a_prefill_marks_each_span_inside_its_parent(model):
    arch, _, bundle, params, batch = model
    step = steps.make_prefill_step(bundle)
    _, marks = traced(lambda: step(params, batch))
    spans.counters()
    got = {}
    for e in marks:
        got[e.name] = got.get(e.name, 0) + 1
    assert got == WANT[arch]
    assert len({e.thread for e in marks}) == 1
    for e in marks:
        parent = parent_of(e.name)
        if parent is None:
            continue
        assert any(p.name == parent
                   and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end
                   for p in marks), e.name


def test_outside_a_profiler_nothing_is_called(model):
    _, _, bundle, params, batch = model
    step = steps.make_prefill_step(bundle)
    spans.counters()
    assert not spans.recording()
    refuse = unittest.mock.Mock(side_effect=AssertionError("called"))
    with unittest.mock.patch.object(torch.profiler, "record_function",
                                    refuse), \
            unittest.mock.patch.object(torch.autograd.profiler,
                                       "record_function", refuse):
        assert spans.span("model.attn") is spans.span("model.ffn")
        assert spans.span("model.attn") is spans._NULL
        step(params, batch)
    refuse.assert_not_called()
    assert spans.counters() == {}


def test_results_are_the_same_bits_traced_or_not(model):
    _, _, bundle, params, batch = model
    step = steps.make_prefill_step(bundle)
    want_logits, want_cache = step(params, batch)
    (logits, cache), _ = traced(lambda: step(params, batch))
    spans.counters()
    assert torch.equal(logits, want_logits)
    flat = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(flat(cache),
                                                 flat(want_cache)))
    assert len(flat(cache)) == len(flat(want_cache))


def test_kept_counts_the_plain_dispatch_keep():
    """At capacity factor 0.5 (8 slots an expert for 16 entries on
    average) entries drop; the counter equals the plain bookkeeping's
    keep, summed over the batch rows, and slots are B·E·C."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params, _, _ = serve.random_request(cfg, B, S, 3, "cpu")
    p = tree_map(lambda t: t[0], params["layers"]["mlp"])  # a MoE layer
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    m = cfg.moe
    C = moe.expert_capacity(S, m.num_experts, m.top_k, m.capacity_factor)
    spans.counters()
    with torch.inference_mode():
        traced(lambda: moe.moe_apply(cfg, p, x, Sharder(None, None)))
        got = spans.counters()
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
        _, experts, _ = moe.route(cfg, p, h)
    kept = sum(int(moe.dispatch_indices(row.reshape(-1), m.num_experts,
                                        C)[2].sum())
               for row in experts.view(B, S * m.top_k))
    assert kept < B * S * m.top_k                     # entries dropped
    assert got == {"moe.kept": kept, "moe.slots": B * m.num_experts * C}

