"""The port's spans and counters (``repro_torch/obs/spans.py``): a prefill
under a CPU profiler marks each span of the model code once where it
should, inside its parent on one thread; outside a profiler ``span`` is
the shared null context and calls nothing of torch's profiler, and no
counter moves; the results are the same bits with the profiler on or
off; ``moe.kept`` counts what the plain ``dispatch_indices`` keeps; and
``moe.expert_major`` counts each MoE layer of a one-device prefill
once, and ``moe.combine_kernel`` each one whose combine took the kernel
(on the card only)."""
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


def test_a_prefill_counts_the_expert_major_path_once_a_moe_layer(model):
    """On one device every MoE layer runs the expert-major buffer: the
    counter reads the number of MoE layers (none in the dense model)."""
    _, cfg, bundle, params, batch = model
    step = steps.make_prefill_step(bundle)
    spans.counters()
    traced(lambda: step(params, batch))
    got = spans.counters()
    n_moe = cfg.num_layers - cfg.moe.first_dense if cfg.moe else 0
    assert got.get("moe.expert_major", 0) == n_moe
    assert cfg.moe is None or n_moe == 2
    assert "moe.combine_kernel" not in got          # the CPU's is plain


@pytest.mark.cuda
def test_the_card_counts_the_combine_kernel_once_a_moe_layer():
    """On the card every MoE layer of a one-device prefill combines on the
    moe_combine kernel: the counter and the kernel's launches read the
    number of MoE layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.kernels.moe_combine import moe_combine as MK
    cfg = smoke_config("deepseek-v2-lite-16b")
    bundle = build_model(cfg)
    params, tokens, _ = serve.random_request(cfg, B, S, 7, "cuda")
    batch = serve.prefill_batch(bundle, tokens)
    step = steps.make_prefill_step(bundle)
    spans.counters()
    before = MK.launches
    traced(lambda: step(params, batch))
    got = spans.counters()
    n_moe = cfg.num_layers - cfg.moe.first_dense
    assert got["moe.combine_kernel"] == got["moe.expert_major"] == n_moe
    assert MK.launches - before == n_moe


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
    assert got == {"moe.kept": kept, "moe.slots": B * m.num_experts * C,
                   "moe.expert_major": 1}

