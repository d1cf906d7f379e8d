"""The deepseek-v2 serving slice of the PyTorch port against the JAX
package: the MLA attention block (full sequence and decode over the
compressed cache, at the smoke config and at the published width), the
parameter, cache and batch definitions, and the whole ``_deepseek``
model's prefill, decode and greedy serving loop at its smoke config (3
layers, d_model 64, 4 experts top 2, 1 shared expert, q/k 24 and v 16).

Weights come from the reference's ``init_params`` through
``repro_torch.models.bridge`` (constant leaves perturbed); tokens,
activations and caches are numpy from a seed. On the CPU the MLA prefill
attends through the reference's own algorithm and the MoE dispatch
through ``partition_pack``'s plain version; the card's kernels are held
to them in tests/test_torch_cuda.py. Tolerances: f32 1e-4 (sums in
another order); bf16 5 % relative L2 (``_torch_parity.BF16_TOL``); the
decode replay against the prefill 2e-3, as
tests/test_serve_consistency.py holds the reference."""
import ast
import dataclasses

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
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as PK  # noqa
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, cast_params, cast_params_)
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, param_count, tree_leaves)

from _torch_parity import (both, close, match, perturb,  # noqa: E402
                           spec_rows_port, spec_rows_ref)

ARCH = "deepseek-v2-lite-16b"
B_SERVE, S_SERVE = 2, 16


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _cfgs(full=False, bf16=False, capacity_factor=None):
    jcfg = (jax_get_config if full else jax_smoke_config)(ARCH)
    tcfg = (get_config if full else smoke_config)(ARCH)
    if full or bf16:
        dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                         torch.float32)
        jcfg = jcfg.replace(compute_dtype=dt[0])
        tcfg = tcfg.replace(compute_dtype=dt[1])
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


# ------------------------------------------------------------ MLA block
def _mla_params(jcfg, seed):
    return both(perturb(jax_init_params(JT.mla_defs(jcfg),
                                        jax.random.key(seed)), seed))


def _mla_prefill_then_decode(jcfg, tcfg, S, steps, seed):
    """A prefill of S tokens, then ``steps`` decode tokens against a cache
    of S + steps slots holding the prefill's compressed kv: outputs and
    caches compared at every step."""
    pj, pt = _mla_params(jcfg, seed)
    B = 2
    x = _np(B, S + steps, jcfg.d_model, seed=seed + 1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, cj = JT.mla_apply(jcfg, pj, jnp.asarray(x[:, :S]), JaxSharder(),
                          positions=jnp.asarray(pos))
    before = FK.launches, FK.routed
    yt, ct = TT.mla_apply(tcfg, pt, _t(x[:, :S]), Sharder(),
                          positions=_t(pos, torch.int32))
    assert (FK.launches, FK.routed) == before      # the CPU's plain path
    close(yt, yj)
    close(ct["ckv"], cj["ckv"])
    close(ct["krope"], cj["krope"])
    assert ct["ckv"].shape == (B, S, tcfg.kv_lora_rank)
    cj = {n: jnp.pad(cj[n], ((0, 0), (0, steps), (0, 0))) for n in cj}
    ct = {n: torch.nn.functional.pad(ct[n], (0, 0, 0, steps)) for n in ct}
    for t in range(steps):
        p = np.full((B, 1), S + t, np.int32)
        xs = x[:, S + t:S + t + 1]
        yj, cj = JT.mla_apply(jcfg, pj, jnp.asarray(xs), JaxSharder(),
                              positions=jnp.asarray(p), cache=cj,
                              cache_len=jnp.int32(S + t))
        yt, ct2 = TT.mla_apply(tcfg, pt, _t(xs), Sharder(),
                               positions=_t(p, torch.int32), cache=ct,
                               cache_len=torch.tensor(S + t,
                                                      dtype=torch.int32))
        assert ct2 is ct                           # written in place
        close(yt, yj)
        close(ct["ckv"], cj["ckv"])
        close(ct["krope"], cj["krope"])


@pytest.mark.parametrize("S", [16, 5])
def test_mla_prefill_and_decode_match_reference(S):
    """The smoke config's MLA block (4 heads, q/k 24 = 16 nope + 8 rope, v
    16, kv rank 32): the prefill's output and compressed cache, then three
    decode steps with the absorbed projections."""
    jcfg, tcfg = _cfgs()
    _mla_prefill_then_decode(jcfg, tcfg, S, 3, 11)


def test_mla_block_at_full_width_matches_reference():
    """deepseek-v2-lite's MLA block at its published width (d_model 2048,
    16 heads, q/k 192 = 128 nope + 64 rope, v 128, kv rank 512) in f32: a
    prefill of 32 tokens, then one decode step."""
    jcfg, tcfg = _cfgs(full=True)
    _mla_prefill_then_decode(jcfg, tcfg, 32, 1, 12)


def test_mla_decode_refuses_a_slot_past_the_cache():
    """The reference's dynamic_update_slice would clamp the slot; the port
    writes in place and raises, as its GQA decode does."""
    _, tcfg = _cfgs()
    jcfg = jax_smoke_config(ARCH)
    pt = tree_from_numpy(jax.tree.map(np.asarray, jax_init_params(
        JT.mla_defs(jcfg), jax.random.key(0))), "cpu")
    cache = {"ckv": torch.zeros(1, 4, tcfg.kv_lora_rank),
             "krope": torch.zeros(1, 4, tcfg.qk_rope_head_dim)}
    with pytest.raises(IndexError, match="out of bounds"):
        TT.mla_apply(tcfg, pt, torch.zeros(1, 1, tcfg.d_model), Sharder(),
                     positions=torch.full((1, 1), 4, dtype=torch.int32),
                     cache=cache, cache_len=torch.tensor(4))


# ----------------------------------------------------------------- defs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_cache_and_batch_defs_match_reference(smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(
        ARCH))
    tb = build_model((smoke_config if smoke else get_config)(ARCH))
    assert spec_rows_port(tb.param_defs) == spec_rows_ref(jb.param_defs)
    assert spec_rows_port(tb.cache_defs(4, 544)) == \
        spec_rows_ref(jb.cache_defs(4, 544))
    for kind in ("prefill", "decode"):
        assert spec_rows_port(tb.batch_defs(ShapeConfig("serve", 512, 4,
                                                        kind))) == \
            spec_rows_ref(jb.batch_defs(JaxShape("serve", 512, 4, kind)))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    if not smoke:
        assert param_count(tb.param_defs) == 15_706_484_224
        assert tb.param_defs["layers"]["mlp"]["w_gate"].shape == \
            (26, 64, 2048, 1408)


# ------------------------------------------------------- the whole model
def _models(seed=5, bf16=False, capacity_factor=None):
    jcfg, tcfg = _cfgs(bf16=bf16, capacity_factor=capacity_factor)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B_SERVE, S_SERVE)).astype(np.int32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prefill_logits_match_reference(bf16):
    """At the config's own capacity factor (1.5), where some entries drop
    in the smoke config's 2 x 16-token groups: the logits and every
    layer's compressed cache."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16)
    lj, cj = jax.jit(jax_prefill(jb))(pj, {"tokens": jnp.asarray(tokens)})
    before = PK.launches
    lt, ct = make_prefill_step(tb)(pt, {"tokens": torch.from_numpy(tokens)})
    assert PK.launches == before                  # the CPU takes no kernel
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == S_SERVE
    assert bool(torch.isfinite(lt.float()).all())
    match(lt, lj, bf16)
    for n in ("ckv", "krope"):
        assert ct["ls"][n].shape == cj["ls"][n].shape
        match(ct["l0"][n], cj["l0"][n], bf16)
        match(ct["ls"][n], cj["ls"][n], bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_decode_logits_match_reference_every_step(bf16):
    """In bf16 the reference runs op by op (``jax.disable_jit``), rounding
    after every op as eager PyTorch does. Jitted, XLA keeps excess
    precision inside its fusions, and the smoke config's router (4
    experts, weights drawn at 0.02, so the four probabilities sit near
    1/4) then picks another second expert for one token at step 2 of
    this prompt: 0.09 relative L2 there, 0.008-0.02 at the other steps.
    A near-tie flips with rounding; it is not a difference of the
    algorithm."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    dec_j = jax_decode(jb) if bf16 else jax.jit(jax_decode(jb))
    dec_t = make_decode_step(tb)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        with jax.disable_jit(bf16):
            lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok)})
        lt, ct = dec_t(pt, ct, {"token": torch.from_numpy(tok)})
        match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    assert ct["ls"]["ckv"].dtype == tcfg.compute_dtype
    match(ct["ls"]["ckv"], cj["ls"]["ckv"], bf16)


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI for deepseek-v2-lite-16b --smoke
    (weights from key 0, prompts from numpy seed 0) against the port's
    ``generate`` on the same weights and prompts: the same greedy
    tokens."""
    batch, plen, new = 2, 16, 8
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke"])
    jax_serve.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{ARCH}:")
    want = [ast.literal_eval(line.split(":", 1)[1]) for line in lines
            if line.strip().startswith("seq")]
    assert len(want) == batch and all(len(w) == new for w in want)
    jcfg = jax_smoke_config(ARCH)
    pj = jax_init_params(jax_build_model(jcfg).param_defs, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (batch, plen)).astype(np.int32)
    out = serve.generate(smoke_config(ARCH), tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), torch.from_numpy(tokens), new,
        "cpu")
    assert out.tokens.tolist() == want
    assert out.decode_steps == plen + new - 1


def test_decode_replay_matches_prefill():
    """tests/test_serve_consistency.py's deepseek case on the port: with
    capacity_factor 100 (decode never drops, so neither may the prefill),
    replaying the prompt through decode gives the prefill's last-position
    logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens = _models(seed=6, capacity_factor=100.0)
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu")
    close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


def test_cast_params_in_place_equals_cast_params():
    """``cast_params_`` casts the tree's own dicts leaf by leaf to what
    ``cast_params`` returns: the same leaves, bit for bit, and bf16 logits
    exactly equal."""
    _, tcfg, _, tb, _, pt, tokens = _models(seed=7, bf16=True)
    want = cast_params(tcfg, pt)
    got = {k: v for k, v in pt.items()}
    assert cast_params_(tcfg, got) is got
    for a, b in zip(tree_leaves(got, torch.is_tensor),
                    tree_leaves(want, torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["layers"]["mlp"]["w_gate"].dtype == torch.bfloat16
    step = make_prefill_step(tb)
    batch = {"tokens": torch.from_numpy(tokens)}
    assert torch.equal(step(got, batch)[0], step(pt, batch)[0])


def test_serve_cli_serves_deepseek_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2
    assert serve.CELLS[ARCH] == serve.ServeCell(ARCH)


def test_llama4_builds_and_serves_on_cpu():
    """The moe family without MLA (llama4) takes its own builder, with
    super-blocks of 4 sub-layers in place of deepseek's layer 0 and MoE
    stack, and serves on the CPU (tests/test_torch_llama4.py holds it
    against the reference)."""
    cfg = smoke_config("llama4-maverick-400b-a17b")
    bundle = build_model(cfg)
    assert set(bundle.param_defs) >= {"blocks"} and \
        "layer0" not in bundle.param_defs
    params, tokens, _ = serve.random_request(cfg, 2, 8, 0, "cpu")
    out = serve.generate(cfg, params, tokens, 2, "cpu")
    assert tuple(out.tokens.shape) == (2, 2)
    assert bool(torch.isfinite(out.prefill_logits).all())
