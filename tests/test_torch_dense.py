"""The dense decoder serving slice of the PyTorch port against the JAX
package: rope and mrope, the attention flavors, the GQA attention block in
every layer kind (full sequence and decode), the MLPs, one glm4-9b layer
at full width, the parameter, cache and batch definitions of the five
dense and vlm archs, and the whole model's prefill, decode and greedy
serving loop at their smoke configs.

Weights come from the reference's ``init_params`` and cross over through
``repro_torch.models.bridge``; the leaves the reference initializes to
constants (norm scales, LayerNorm and MLP biases) are first given random
values so that every parameter moves the output. Tokens, activations and
caches are numpy from a seed. On the CPU the port's prefill attention runs
the reference's own algorithm (``attention.attention``); the CUDA kernel
that replaces it on the card is held against the plain oracle in
tests/test_torch_flash_gqa.py and tests/test_torch_cuda.py. Tolerances:
f32 1e-4 for models (sums in another order), 1e-5 for single ops; bf16 5 %
relative L2 for logits (``_torch_parity.BF16_TOL``) and one bf16 rounding
(2e-2) for single ops."""
import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as K  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model, cast_params  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, param_count)

from _torch_parity import (both, close, match, perturb,  # noqa: E402
                           spec_rows_port, spec_rows_ref)

DENSE = ["glm4-9b", "granite-20b", "qwen2-vl-7b", "smollm-135m",
         "starcoder2-3b"]
OP_TOL = 1e-5               # one op in f32
OP_TOL_BF16 = 2e-2          # one op in bf16: a rounding or two apart


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ------------------------------------------------------------------ rope
@pytest.mark.parametrize("fraction", [1.0, 0.5], ids=["full", "partial"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_rope_matches_reference(fraction, bf16):
    """glm4 rotates half of each head (rope_fraction 0.5); cos and sin are
    cast to x's dtype before the multiply, on both sides."""
    x = _np(2, 12, 4, 16, seed=1, scale=2)
    pos = np.random.default_rng(2).integers(0, 500, (2, 12)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = JA.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0,
                         fraction)
    got = TA.apply_rope(_t(x, tdt), _t(pos, torch.int32), 10000.0, fraction)
    assert got.dtype == tdt
    close(got, want, OP_TOL_BF16 if bf16 else OP_TOL)


def test_mrope_matches_reference():
    x = _np(2, 10, 4, 16, seed=3)
    pos = np.random.default_rng(4).integers(0, 64, (3, 2, 10)).astype(
        np.int32)
    want = JA.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = TA.apply_mrope(_t(x), _t(pos, torch.int32), 1e6, (2, 3, 3))
    close(got, want, OP_TOL)


# ------------------------------------------------------------- attention
CHUNKED = {
    # Sq, Skv, causal, window, chunk, q_offset, kv_valid_len
    "causal-padded": (20, 20, True, 0, 8, 0, None),
    "q-offset": (8, 24, True, 0, 4, 16, None),
    "window": (24, 24, True, 5, 8, 0, None),
    "kv-valid-len": (6, 24, False, 0, 4, 0, (10, 24)),
    "bidir": (16, 16, False, 0, 8, 0, None),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_attention_matches_reference(case, bf16):
    Sq, Skv, causal, window, chunk, q_offset, kvl = CHUNKED[case]
    q, k, v = (_np(2, s, 4, 16, seed=i) for i, s in enumerate((Sq, Skv,
                                                               Skv)))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    want = JA.chunked_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), **kw,
        kv_valid_len=None if kvl is None else jnp.asarray(kvl))
    got = TA.chunked_attention(
        *(_t(a, tdt) for a in (q, k, v)), **kw,
        kv_valid_len=None if kvl is None else torch.tensor(kvl))
    assert got.dtype == tdt and got.shape == (2, Sq, 4, 16)
    close(got, want, OP_TOL_BF16 if bf16 else OP_TOL)


@pytest.mark.parametrize("S,chunk", [(32, 8), (16, 8), (12, 8)],
                         ids=["split-twice", "split-once", "fallback"])
def test_causal_split_attention_matches_reference(S, chunk):
    q, k, v = (_np(2, S, 4, 16, seed=10 + i) for i in range(3))
    want = JA.causal_split_attention(*map(jnp.asarray, (q, k, v)),
                                     chunk=chunk)
    got = TA.causal_split_attention(*map(_t, (q, k, v)), chunk=chunk)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_block_tri_attention_matches_reference(window):
    q, k, v = (_np(2, 32, 4, 16, seed=20 + i) for i in range(3))
    want = JA.block_tri_attention(*map(jnp.asarray, (q, k, v)),
                                  window=window, chunk=8)
    got = TA.block_tri_attention(*map(_t, (q, k, v)), window=window,
                                 chunk=8)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("impl,window", [("block_tri", 0), ("block_tri", 4),
                                         ("chunked", 0)])
def test_attention_dispatch_matches_reference(impl, window):
    q, k, v = (_np(1, 24, 2, 16, seed=30 + i) for i in range(3))
    want = JA.attention(*map(jnp.asarray, (q, k, v)), impl=impl,
                        window=window, chunk=8)
    got = TA.attention(*map(_t, (q, k, v)), impl=impl, window=window,
                       chunk=8)
    close(got, want, OP_TOL)


@pytest.mark.parametrize("cache_len", [7, (3, 12)], ids=["scalar", "per-row"])
def test_decode_attention_matches_reference(cache_len):
    q = _np(2, 1, 4, 16, seed=40)
    kc, vc = _np(2, 12, 4, 16, seed=41), _np(2, 12, 4, 16, seed=42)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(cache_len))
    got = TA.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(cache_len))
    close(got, want, OP_TOL)


def test_repeat_kv_matches_reference():
    k = _np(2, 5, 3, 4, seed=43)
    np.testing.assert_array_equal(TA.repeat_kv(_t(k), 4).numpy(),
                                  np.asarray(JA.repeat_kv(jnp.asarray(k), 4)))


# ------------------------------------------------------- attention block
def _block_cfgs(arch: str):
    """Smoke configs (f32) with a window of 6 and local chunks of 8, so
    every layer kind has something to mask."""
    kw = dict(window=6, chunked_local=8)
    return (jax_smoke_config(arch).replace(**kw),
            smoke_config(arch).replace(**kw))


def _attn_params(jcfg, seed):
    return both(perturb(jax_init_params(JT.attn_defs(jcfg),
                                        jax.random.key(seed)), seed))


@pytest.mark.parametrize("kind", ["full", "window", "bidir", "chunked"])
@pytest.mark.parametrize("arch", ["glm4-9b", "smollm-135m"])
def test_attn_apply_full_sequence_matches_reference(arch, kind):
    """glm4 (partial rope, GQA 2:1 at smoke) and smollm (9/3 heads padded
    to 16/4, head mask): the output and the kv the prefill caches."""
    jcfg, tcfg = _block_cfgs(arch)
    pj, pt = _attn_params(jcfg, 1)
    B, S = 2, 16
    x = _np(B, S, jcfg.d_model, seed=2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, kvj = JT.attn_apply(jcfg, pj, jnp.asarray(x), JaxSharder(),
                            positions=jnp.asarray(pos), layer_kind=kind)
    yt, kvt = TT.attn_apply(tcfg, pt, _t(x), Sharder(),
                            positions=_t(pos, torch.int32), layer_kind=kind)
    close(yt, yj)
    close(kvt["k"], kvj["k"])
    close(kvt["v"], kvj["v"])
    assert kvt["k"].shape == (B, S, TT._heads(tcfg)[1],
                              tcfg.resolved_head_dim)


DECODE_POS = {"full": (5, 6, 7), "window": (10, 11, 12),   # 12 % 12 wraps
              "bidir": (5, 6, 7), "chunked": (6, 7, 8)}    # 8 % 8 wraps


@pytest.mark.parametrize("kind", sorted(DECODE_POS))
@pytest.mark.parametrize("arch", ["glm4-9b", "smollm-135m"])
def test_attn_apply_decode_matches_reference(arch, kind):
    """Three tokens from a random cache of 12 slots, through the ring for
    the window and chunked kinds: the outputs, and the port's cache
    (written in place) against the reference's returned one."""
    jcfg, tcfg = _block_cfgs(arch)
    pj, pt = _attn_params(jcfg, 3)
    B, W = 2, 12
    Hkv, hd = TT._heads(tcfg)[1], tcfg.resolved_head_dim
    cj, ct = both({"k": _np(B, W, Hkv, hd, seed=4),
                   "v": _np(B, W, Hkv, hd, seed=5)})
    x = _np(B, 3, jcfg.d_model, seed=6)
    for t, p in enumerate(DECODE_POS[kind]):
        pos = np.full((B, 1), p, np.int32)
        yj, cj = JT.attn_apply(jcfg, pj, jnp.asarray(x[:, t:t + 1]),
                               JaxSharder(), positions=jnp.asarray(pos),
                               layer_kind=kind, cache=cj,
                               cache_len=jnp.int32(p))
        yt, ct2 = TT.attn_apply(tcfg, pt, _t(x[:, t:t + 1]), Sharder(),
                                positions=_t(pos, torch.int32),
                                layer_kind=kind, cache=ct,
                                cache_len=torch.tensor(p, dtype=torch.int32))
        assert ct2 is ct                           # written in place
        close(yt, yj)
        close(ct["k"], cj["k"])
        close(ct["v"], cj["v"])


def test_decode_refuses_a_slot_past_the_cache():
    """The reference's dynamic_update_slice would clamp the slot; the port
    raises."""
    _, tcfg = _block_cfgs("glm4-9b")
    pt = tree_from_numpy(jax.tree.map(np.asarray, jax_init_params(
        JT.attn_defs(jax_smoke_config("glm4-9b")), jax.random.key(0))),
        "cpu")
    cache = {k: torch.zeros(1, 4, 2, 16) for k in ("k", "v")}
    x = torch.zeros(1, 1, tcfg.d_model)
    with pytest.raises(IndexError, match="out of bounds"):
        TT.attn_apply(tcfg, pt, x, Sharder(),
                      positions=torch.full((1, 1), 4, dtype=torch.int32),
                      cache=cache, cache_len=torch.tensor(4))


@pytest.mark.parametrize("arch", ["glm4-9b", "starcoder2-3b"],
                         ids=["swiglu", "gelu"])
@pytest.mark.parametrize("S", [16, 1], ids=["full-seq", "decode"])
def test_mlp_apply_matches_reference(arch, S):
    """SwiGLU with RMSNorm (glm4); GELU with biases and LayerNorm
    (starcoder2)."""
    jcfg = jax_smoke_config(arch)
    pj, pt = both(perturb(jax_init_params(JT.mlp_defs(jcfg),
                                          jax.random.key(7)), 7))
    x = _np(2, S, jcfg.d_model, seed=8)
    close(TT.mlp_apply(smoke_config(arch), pt, _t(x), Sharder()),
          JT.mlp_apply(jcfg, pj, jnp.asarray(x), JaxSharder()))


def test_glm4_layer_at_full_width_matches_reference():
    """One glm4-9b layer at its published width (d_model 4096, 32 q heads
    over 2 kv heads of 128, partial rope, d_ff 13696) in f32: a prefill of
    32 tokens, then one decode step against the cache it made."""
    jcfg = jax_get_config("glm4-9b").replace(compute_dtype=jnp.float32)
    tcfg = get_config("glm4-9b").replace(compute_dtype=torch.float32)
    pj, pt = both(perturb(jax_init_params(JT.layer_defs(jcfg),
                                          jax.random.key(9)), 9))
    B, S = 1, 32
    x = _np(B, S + 1, jcfg.d_model, seed=10)
    pos = np.arange(S, dtype=np.int32)[None]
    yj, kvj, _ = JT.layer_apply(jcfg, pj, jnp.asarray(x[:, :S]),
                                JaxSharder(), positions=jnp.asarray(pos))
    yt, kvt, _ = TT.layer_apply(tcfg, pt, _t(x[:, :S]), Sharder(),
                                positions=_t(pos, torch.int32))
    close(yt, yj)
    close(kvt["k"], kvj["k"])
    cj = {n: jnp.pad(kvj[n], ((0, 0), (0, 1), (0, 0), (0, 0)))
          for n in ("k", "v")}
    ct = {n: torch.nn.functional.pad(kvt[n], (0, 0, 0, 0, 0, 1))
          for n in ("k", "v")}
    step = np.full((B, 1), S, np.int32)
    yj, _, _ = JT.layer_apply(jcfg, pj, jnp.asarray(x[:, S:]), JaxSharder(),
                              positions=jnp.asarray(step), cache=cj,
                              cache_len=jnp.int32(S))
    yt, _, _ = TT.layer_apply(tcfg, pt, _t(x[:, S:]), Sharder(),
                              positions=_t(step, torch.int32), cache=ct,
                              cache_len=torch.tensor(S, dtype=torch.int32))
    close(yt, yj)


# ----------------------------------------------------------------- defs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_cache_and_batch_defs_match_reference(arch, smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(arch))
    tb = build_model((smoke_config if smoke else get_config)(arch))
    assert spec_rows_port(tb.param_defs) == spec_rows_ref(jb.param_defs)
    assert spec_rows_port(tb.cache_defs(4, 544)) == \
        spec_rows_ref(jb.cache_defs(4, 544))
    for kind in ("prefill", "decode"):
        assert spec_rows_port(tb.batch_defs(ShapeConfig("serve", 512, 4,
                                                        kind))) == \
            spec_rows_ref(jb.batch_defs(JaxShape("serve", 512, 4, kind)))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    if arch == "glm4-9b" and not smoke:
        assert param_count(tb.param_defs) == 9_399_767_040


# ------------------------------------------------------- the whole model
B_SERVE, S_SERVE = 2, 16


def _models(arch: str, seed: int = 5, bf16: bool = False):
    """Smoke-config models of ``arch`` on one set of bridged weights
    (constant leaves perturbed), with prompts from numpy; ``bf16`` computes
    in bf16 (the weights stay f32)."""
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    if bf16:
        jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B_SERVE, S_SERVE)).astype(np.int32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens


def _prefill_batches(jcfg, tokens, seed):
    """The same prefill batch for both packages; a vlm's vision embeddings
    and mrope positions are random, so both move the logits."""
    rng = np.random.default_rng(seed)
    b = {"tokens": tokens}
    if jcfg.family == "vlm":
        P = min(jcfg.vision_prefix, S_SERVE // 2)
        b["vision_embeds"] = rng.standard_normal(
            (B_SERVE, P, jcfg.d_model)).astype(np.float32)
    if jcfg.mrope:
        b["mrope_positions"] = rng.integers(
            0, S_SERVE, (3, B_SERVE, S_SERVE)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference(arch, bf16):
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(arch, bf16=bf16)
    bj, bt = _prefill_batches(jcfg, tokens, 6)
    lj, cj = jax.jit(jax_prefill(jb))(pj, bj)
    lt, ct = make_prefill_step(tb)(pt, bt)
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == S_SERVE
    assert bool(torch.isfinite(lt.float()).all())
    match(lt, lj, bf16)
    assert ct["kv"]["k"].shape == cj["kv"]["k"].shape
    match(ct["kv"]["k"], cj["kv"]["k"], bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_logits_match_reference_every_step(arch, bf16):
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(arch, bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    dec_j, dec_t = jax.jit(jax_decode(jb)), make_decode_step(tb)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok)})
        lt, ct = dec_t(pt, ct, {"token": torch.from_numpy(tok)})
        match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    assert ct["kv"]["k"].dtype == tcfg.compute_dtype
    match(ct["kv"]["v"], cj["kv"]["v"], bf16)


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI at its defaults (smollm-135m --smoke:
    weights from key 0, prompts from numpy seed 0) against the port's
    ``generate`` on the same weights and prompts: the same greedy
    tokens."""
    batch, plen, new = 2, 16, 8
    monkeypatch.setattr("sys.argv", ["serve", "--smoke"])
    jax_serve.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("smollm-135m:")
    want = [ast.literal_eval(line.split(":", 1)[1]) for line in lines
            if line.strip().startswith("seq")]
    assert len(want) == batch and all(len(w) == new for w in want)
    jcfg = jax_smoke_config("smollm-135m")
    pj = jax_init_params(jax_build_model(jcfg).param_defs, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (batch, plen)).astype(np.int32)
    out = serve.generate(smoke_config("smollm-135m"), tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), torch.from_numpy(tokens), new,
        "cpu")
    assert out.tokens.dtype == torch.int32
    assert out.tokens.tolist() == want
    assert out.decode_steps == plen + new - 1


def test_decode_replay_matches_prefill():
    """tests/test_serve_consistency.py's glm4-9b case on the port:
    replaying the prompt through decode gives the prefill's last-position
    logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens = _models("glm4-9b", seed=6)
    before = K.launches
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu")
    assert K.launches == before                 # the CPU takes no kernel
    close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


@pytest.mark.parametrize("arch", DENSE)
def test_cast_params_changes_no_number(arch):
    """Casting the weights to the compute dtype once equals the model's
    cast at every use: bf16 compute, exactly equal logits. starcoder2's
    LayerNorm reads its scale and bias in f32, so they stay f32."""
    _, tcfg, _, tb, _, pt, tokens = _models(arch, seed=7, bf16=True)
    cp = cast_params(tcfg, pt)
    keep_f32 = tcfg.norm_kind == "ln"
    assert (cp["final_ln"]["scale"].dtype == torch.float32) == keep_f32
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    _, bt = _prefill_batches(jax_smoke_config(arch), tokens, 8)
    step = make_prefill_step(tb)
    assert torch.equal(step(pt, bt)[0], step(cp, bt)[0])


def test_serve_cli_default_arch_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "smollm-135m: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2
