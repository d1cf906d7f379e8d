"""granite-4.0-h-small at smoke width on the CPU (d 64, 6 layers: five
Mamba-2 then one attention layer, the published pattern's first six; 8
routed experts top 2, 4 held here): the port's prefill against the plain
reference in float32 with the fp8 control far from both; prefill, then
decode through the handed-off cache, against the reference's full
forward; the expert share, whose parts add up to the uncut layer in the
program and in the reference; the smoke cell through the harness; the
file's sizes and the benchmark's SSD arithmetic; and the new readers on
synthetic profiler records."""
import dataclasses
import json
import math
import types

import pytest
import torch
import torch.nn.functional as F

import _plain
import _smoke
from harness import cell as C
from harness import flops, ssd, weights
from repro_torch.launch import serve, steps
from repro_torch.models import model
from repro_torch.models.modules import Sharder
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.modules import init_params
from test_bench_spans import Ev, kernel, span

NAME = "granite-4.0-h-small"
CONF = C.BENCH / "configs" / f"{NAME}.json"
SIZES = {"num_hidden_layers": 6, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "mamba_d_head": 16, "mamba_n_heads": 8, "mamba_d_state": 16,
         "mamba_chunk_size": 8, "intermediate_size": 32,
         "shared_intermediate_size": 48, "num_experts_per_tok": 2,
         "vocab_size": 512}
ROUTED = 8
TOL = 1e-5            # f32, the two paths' rounding (about 1e-6 here)


def smoke_conf(dtype="float32", held=4, first=0, factor=None) -> dict:
    """The configuration file at smoke width: ``held`` experts from
    ``first`` of 8 here, the capacity factor ``factor`` (None: the
    file's), the program held to the same sizes."""
    conf = json.loads(CONF.read_text())
    conf.update(SIZES, num_local_experts=held, name=f"{NAME}-smoke",
                compute_dtype=dtype,
                kv_handoff_tokens=4 * _smoke.MIX["batch_tokens"])
    conf["expert_share"] = dict(conf["expert_share"], routed=ROUTED,
                                first_held=first)
    if factor:
        conf["capacity"] = dict(conf["capacity"], factor=factor)
    rep = dict(conf["program"]["replace"], head_dim=16, logit_chunk=0,
               compute_dtype=dtype, moe={})
    for field, key in conf["program"]["matches"].items():
        if field.startswith("moe."):
            rep["moe"][field[4:]] = C.lookup(conf, key)
        else:
            rep[field] = C.lookup(conf, key)
    conf["program"]["replace"] = rep
    return conf


def pool(conf, seed=11):
    """(bundle, params, flat weights, reference) at ``conf``; the leaves
    the harness fills with zeros or ones (A_log, D, dt_bias, the conv's
    bias, the norms) drawn at random too, so that each is exercised."""
    cfg = C.program_config(conf)
    bundle = model.build_model(cfg)
    params, flat = weights.draw(bundle.param_defs, seed, "cpu",
                                torch.float32)
    gen = torch.Generator().manual_seed(seed)
    for name, spec in weights.flat_specs(bundle.param_defs):
        if spec.init in ("zeros", "ones"):
            flat[name].add_(0.3 * torch.randn(spec.shape, generator=gen))
    return bundle, params, flat, C.reference(C.BENCH, conf["reference"])


def rel(a, b):
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


@pytest.mark.parametrize("B, S", [(4, 32), (2, 64)])
def test_reference_matches_the_port(B, S):
    conf = smoke_conf()
    bundle, params, flat, ref = pool(conf)
    kinds = model.layer_kinds(bundle.cfg)
    assert kinds == ("mamba",) * 5 + ("attention",)
    toks = torch.randint(0, 512, (B, S),
                         generator=torch.Generator().manual_seed(S)).int()
    got, _ = steps.make_prefill_step(bundle)(
        params, serve.prefill_batch(bundle, toks))
    want = ref.forward(flat, conf, toks, _plain.Exact())
    assert float(rel(got[:, -1], want).max()) < TOL
    ctl = ref.forward(flat, conf, toks, _plain.Fp8())
    assert float(rel(ctl, want).min()) > 0.05


def test_decode_continues_from_the_handoff():
    """Prefill S tokens, then 2 decode steps from the cache the prefill
    hands off (each attention layer's k/v placed in the first S of S + 2
    slots, as the decode tier holds them): the logits of each step are
    the reference's full forward at S + 1 and S + 2. The capacity is one
    slot a token an expert, so that no length drops an entry."""
    conf = smoke_conf(factor=ROUTED / SIZES["num_experts_per_tok"])
    bundle, params, flat, ref = pool(conf)
    B, S = 2, 16
    toks = torch.randint(0, 512, (B, S + 2),
                         generator=torch.Generator().manual_seed(5)).int()
    logits, cache = steps.make_prefill_step(bundle)(
        params, serve.prefill_batch(bundle, toks[:, :S]))
    want = ref.forward(flat, conf, toks[:, :S], _plain.Exact())
    assert float(rel(logits[:, -1], want).max()) < TOL
    layers = cache["layers"]
    assert [sorted(c) for c in layers] == [["conv", "ssm"]] * 5 \
        + [["k", "v"]]
    assert layers[0]["ssm"].shape == (B, 8, 16, 16)
    assert layers[0]["ssm"].dtype == torch.float32
    assert layers[0]["conv"].shape == (B, 3, 128 + 2 * 16)
    assert layers[5]["k"].shape == (B, S, 2, 16)
    cache = {"layers": [c if "ssm" in c else
                        {k: F.pad(t, (0, 0, 0, 0, 0, 2))
                         for k, t in c.items()} for c in layers],
             "len": cache["len"]}
    decode = steps.make_decode_step(bundle)
    for j in range(2):
        lg, cache = decode(params, cache, {"token": toks[:, S + j:S + j + 1]})
        want = ref.forward(flat, conf, toks[:, :S + j + 1], _plain.Exact())
        assert float(rel(lg[:, 0], want).max()) < TOL
    assert int(cache["len"]) == S + 2


def test_the_expert_shares_add_up_to_the_whole_layer():
    """Each share's part of a MoE layer (its held experts' entries, with
    the shared expert) added over both shares, less the shared expert
    counted twice, is the uncut layer's, drops included, in the program
    and in the reference."""
    conf = smoke_conf(held=ROUTED)
    cfg = C.program_config(conf)
    gen = torch.Generator().manual_seed(3)
    p = init_params(moe_defs(cfg), gen, "cpu")
    x = torch.randn(2, 32, 64, generator=gen)
    sh = Sharder()
    routed = ("w_gate", "w_up", "w_down")

    def program(first, n):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe, held_experts=n,
                                                first_held=first))
        q = dict(p, **{k: p[k][first:first + n] for k in routed})
        return moe_apply(c, q, x, sh)[0] - x

    def program_shared():
        q = dict(p, **{k: torch.zeros_like(p[k]) for k in routed})
        return moe_apply(cfg, q, x, sh)[0] - x

    ref = C.reference(C.BENCH, conf["reference"])
    flat = weights.flatten(p)

    def reference(first, n, w=flat):
        c = dict(conf, num_local_experts=n,
                 expert_share=dict(conf["expert_share"], first_held=first))
        q = dict(w, **{k: w[k][first:first + n] for k in routed})

        def at(name):
            return q[name].float()
        at.raw = q.__getitem__
        return ref._moe(ref.sizes(c), c, at, x, _plain.Exact()) - x

    def reference_shared():
        return reference(0, ROUTED, dict(flat, **{
            k: torch.zeros_like(flat[k]) for k in routed}))

    for layer, shared in ((program, program_shared),
                          (reference, reference_shared)):
        a, b, whole, alone = layer(0, 4), layer(4, 4), layer(0, 8), shared()
        assert float(alone.norm()) > 0 and float((a - alone).norm()) > 0
        got = a + b - alone
        assert float(rel(got.reshape(-1, 64), whole.reshape(-1, 64))
                     .max()) < TOL
    # and the two agree on the shares
    assert float(rel(program(0, 4).reshape(-1, 64),
                     reference(0, 4).reshape(-1, 64)).max()) < TOL


def test_the_smoke_cell_runs_through_the_harness(tmp_path):
    root = _smoke.tree(tmp_path)
    conf = smoke_conf()
    f = f"bench/configs/{conf['name']}.json"
    (root / f).write_text(json.dumps(conf))
    cell = f"{conf['name']}.smoke"
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": conf["name"], "source": "smoke",
                           "file": f, "reduced": [], "why": "smoke"})
    man["workloads"].append({"name": cell, "config": conf["name"],
                             "traffic": "smoke", "chips": 1, "why": "smoke"})
    for m in man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "bench" / "checks" / f"{cell}.json").write_text(
        json.dumps({"limits": _smoke.LIMITS}))
    rc, line, err = _smoke.run(root, cell, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert line["metrics"] == {}          # the device's metrics: off card
    rc, line, err = _smoke.run(root, cell)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}


def test_the_file_holds_the_published_model():
    """The registered arch's layer kinds and derived widths are the file's;
    the reference's sizes are the hand-worked ones."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba2
    conf = json.loads(CONF.read_text())
    cfg = C.program_config(conf)
    assert cfg.layer_types == tuple(conf["layer_types"])
    assert get_config(NAME).layer_types == cfg.layer_types
    assert [i for i, k in enumerate(cfg.layer_types)
            if k == "attention"] == [5, 15, 25, 35]
    assert mamba2.dims(cfg)[1] == conf["mamba_n_heads"]
    assert cfg.resolved_head_dim == conf["hidden_size"] \
        // conf["num_attention_heads"]
    assert cfg.rope_theta == 0 and conf["position_embedding_type"] == "nope"
    st = C.reference(C.BENCH, conf["reference"]).structure(conf)
    # a Mamba layer: in_proj 4096 x (2 x 8192 + 2 x 128 + 128), out_proj
    # 8192 x 4096 = 102,236,160, 36 of them; attention 4096 x 4096 x 2 +
    # 4096 x 1024 x 2 = 41,943,040, 4 of them; the MoE: router 4096 x 72,
    # 10 x 36 / 72 routed entries of 3 x 4096 x 768 and the shared 3 x
    # 4096 x 1536 = 66,355,200, 40 of them
    assert st["matmul_params"] == 3_680_501_760 + 167_772_160 \
        + 2_654_208_000
    assert st["ssm"] == {"layers": 36, "heads": 128, "head_dim": 64,
                         "state": 128, "groups": 1, "chunk": 128}
    assert st["attention"] == [{"layers": 4, "heads": 32, "kv_heads": 8,
                                "d_qk": 128, "d_v": 128}]
    assert st["moe"]["experts"] == 72 and st["moe"]["held"] == 36
    assert flops.expert_capacity(16384, st["moe"]) == 3416
    held = sum(math.prod(spec.shape) for _, spec in weights.flat_specs(
        model.build_model(cfg).param_defs))
    assert held == 18_617_793_024


@pytest.mark.parametrize("B, S, chunk", [(2, 16384, 128), (8, 4096, 128),
                                         (1, 96, 128), (3, 64, 16)])
def test_the_ssd_work_is_the_kernels(B, S, chunk):
    """The benchmark's copy of the SSD work reads as the kernel's own
    ``work`` at the call's shapes, in bf16."""
    from repro_torch.kernels.ssd_scan import ops
    st = {"heads": 128, "head_dim": 64, "state": 128, "groups": 1,
          "chunk": chunk}
    assert ssd.work(st, B, S) == ops.work(
        (B, S, 128, 64), (B, S, 1, 128), chunk=chunk, elem_bytes=2)


def _trace(batches=1, ssd_records=4):
    """One prefill a batch (host 0-100 us each): a Mamba mixer with its
    norm and ssd spans, ``ssd_records`` SSD kernels of 10 us, and an
    attention block."""
    ev, t = [], 0
    for b in range(batches):
        o = 1000 * b
        ev += [span("model.prefill", o, o + 100, 1),
               span("model.mixer", o + 10, o + 50, 2),
               span("model.mixer.norm", o + 11, o + 12, 3),
               Ev("cudaLaunchKernel", o + 11, o + 12, 100 + t),
               span("model.mixer.ssd", o + 20, o + 40, 4),
               span("model.attn", o + 60, o + 80, 5),
               Ev("cudaLaunchKernel", o + 61, o + 62, 200 + t),
               kernel("void rms<float>(float*)", o + 100, o + 105, 100 + t),
               kernel("void attn(int)", o + 200, o + 230, 200 + t)]
        for i in range(ssd_records):
            ev += [Ev("cudaLaunchKernel", o + 21 + i, o + 22 + i,
                      300 + 10 * t + i),
                   kernel("void ssd_chunk_scan<4>(float*)", o + 110 + 10 * i,
                          o + 120 + 10 * i, 300 + 10 * t + i)]
        t += 1
    return ev


def _run(events, batches, device="cuda", complete=True):
    st = {"ssm": {"layers": 1, "heads": 128, "head_dim": 64, "state": 128,
                  "groups": 1, "chunk": 128},
          "matmul_params": 1000, "head_params": 10,
          "attention": [{"layers": 1, "heads": 4, "kv_heads": 1,
                         "d_qk": 8, "d_v": 8}]}
    bs = [types.SimpleNamespace(rows=2, seq=256) for _ in range(batches)]
    recs = [types.SimpleNamespace(rows=2, seq=256) for _ in range(3)]
    return types.SimpleNamespace(
        device=torch.device(device), structure=st, records=recs,
        window_s=2.0, profile={"events": events, "complete": complete,
                               "batches": bs})


def test_the_new_readers():
    mixer = C.metric_reader(C.BENCH, "mixer_ms.prefill").read
    roof = C.metric_reader(C.BENCH, "ssd_scan_roofline").read
    mfu = C.metric_reader(C.BENCH, "mfu.prefill_hybrid").read
    run = _run(_trace(2), 2)
    # the norm's 5 us and 4 SSD kernels of 10 us under the mixer, 2
    # batches
    assert mixer(run) == pytest.approx(2 * 45e-3)
    bound = flops.bound_s(*ssd.work(run.structure["ssm"], 2, 256))
    assert roof(run) == pytest.approx(100 * 2 * bound / 80e-6)
    f = 3 * (flops.model_flops(run.structure, 2, 256)
             + ssd.work(run.structure["ssm"], 2, 256)[0])
    assert mfu(run) == pytest.approx(100 * f / 2.0 / flops.PEAK_BF16_FLOPS)
    # None off the card, on a trace that is not whole, with fewer than 4
    # SSD records a Mamba layer a batch, or with no span of the mixer
    for r in (_run(_trace(2), 2, device="cpu"),
              _run(_trace(2), 2, complete=False)):
        assert mixer(r) is None and roof(r) is None
    assert mfu(_run(_trace(2), 2, device="cpu")) is None
    assert roof(_run(_trace(2, ssd_records=3), 2)) is None
    bare = [e for e in _trace(2) if not e.name.startswith("model.mixer")]
    assert mixer(_run(bare, 2)) is None
    no_ssm = _run(_trace(2), 2)
    no_ssm.structure["ssm"] = None
    assert roof(no_ssm) is None and mfu(no_ssm) is None


def test_a_prefill_marks_the_mixer_spans_and_counts_the_handoff():
    """Under a CPU profiler a smoke prefill marks each Mamba-2 mixer's
    spans once a layer, inside the mixer; it counts the bytes of each
    kind of cache it hands off and the routed entries held here; and its
    results are the same bits traced or not."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    conf = smoke_conf()
    bundle, params, _, _ = pool(conf)
    toks = torch.randint(0, 512, (2, 32),
                         generator=torch.Generator().manual_seed(1)).int()
    batch = serve.prefill_batch(bundle, toks)
    step = steps.make_prefill_step(bundle)
    want, _ = step(params, batch)
    spans.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, cache = step(params, batch)
    counted = spans.counters()
    assert torch.equal(got, want)
    marks = [e for e in prof.events() if e.name.startswith("model.")]
    n = {}
    for e in marks:
        n[e.name] = n.get(e.name, 0) + 1
    assert {k: v for k, v in n.items() if k.startswith("model.mixer")} == {
        "model.mixer": 5, "model.mixer.norm": 5, "model.mixer.conv": 5,
        "model.mixer.ssd": 5, "model.mixer.gate": 5}
    assert n["model.attn"] == 1 and n["model.ffn"] == 6
    for e in marks:
        if e.name.startswith("model.mixer."):
            assert any(p.name == "model.mixer"
                       and p.time_range.start <= e.time_range.start
                       and e.time_range.end <= p.time_range.end
                       for p in marks), e.name

    def nbytes(kind):
        return sum(t.numel() * t.element_size() for c in cache["layers"]
                   if ("ssm" in c) == (kind == "ssm") for t in c.values())
    # 5 layers of conv [2, 3, 160] and state [2, 8, 16, 16] in f32; one
    # layer of k and v [2, 32, 2, 16]
    assert counted["ssm.state_bytes"] == nbytes("ssm") \
        == 5 * 4 * (2 * 3 * 160 + 2 * 8 * 16 * 16)
    assert counted["attn.kv_bytes"] == nbytes("kv") == 2 * 4 * 2 * 32 * 32
    # every MoE layer's entries whose expert is one of the 4 held, of the
    # 2 x 32 x 2 routed
    assert 0 < counted["moe.local"] < 6 * 2 * 32 * 2
    assert counted["moe.slots"] == 6 * 2 * 4 * 16
