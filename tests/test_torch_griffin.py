"""The griffin / recurrentgemma serving slice of the PyTorch port against
the JAX package: the RG-LRU scan, the recurrent block (full sequence and
one decode step against its conv ring and state), one recurrent layer at
the published width, the parameter, cache and batch definitions, and the
whole ``_griffin`` model's prefill, decode and greedy serving loop at its
smoke config (5 layers: one (rec, rec, attn) triple and two recurrent
layers; d_model 64, lru 64, 4 q heads over 1 kv head of 16, window 8).

Weights come from the reference's ``init_params`` through
``repro_torch.models.bridge`` (constant leaves perturbed); tokens,
activations and states are numpy from a seed. On the CPU the window
attention runs the reference's own algorithm; ``flash_gqa`` at head dim
256 is held to it on the card in tests/test_torch_cuda.py. The RG-LRU scan
is plain PyTorch on every device. Tolerances: f32 1e-4 (the scan groups
its products otherwise than ``jax.lax.associative_scan``; sums in another
order); bf16 5 % relative L2 (``_torch_parity.BF16_TOL``); the decode
replay against the prefill 2e-3, as tests/test_serve_consistency.py holds
the reference."""
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
from repro.models import griffin as JG  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import griffin as TG  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, param_count)

from _torch_parity import (BF16_TOL, both, close, match,  # noqa: E402
                           perturb, rel_l2, spec_rows_port, spec_rows_ref)

ARCH = "recurrentgemma-9b"
B_SERVE, S_SERVE = 2, 16


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(bf16=False):
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if bf16:
        jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    return jcfg, tcfg


# --------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("S", [1, 7, 16, 100])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init-state"])
def test_rglru_matches_reference(S, init):
    """The log-depth scan against ``jax.lax.associative_scan`` over the
    same combine, with and without an initial state folded in as step 0:
    the outputs and the final state, f32."""
    B, W = 3, 24
    xc, ag, ig = (_np(B, S, W, seed=s) for s in (1, 2, 3))
    lam = _np(W, seed=4)
    h0 = _np(B, W, seed=5) if init else None
    yj, sj = JG._rglru(jnp.asarray(xc), jnp.asarray(ag), jnp.asarray(ig),
                       jnp.asarray(lam),
                       None if h0 is None else jnp.asarray(h0))
    yt, st = TG._rglru(*(torch.from_numpy(a) for a in (xc, ag, ig, lam)),
                       None if h0 is None else torch.from_numpy(h0))
    assert yt.dtype == torch.float32 and st.dtype == torch.float32
    close(yt, yj)
    close(st, sj)


def test_rg_constant_and_defs_match_reference():
    jcfg, tcfg = _cfgs()
    assert TG.RG_C == JG.RG_C
    assert spec_rows_port(TG.rec_defs(tcfg)) == \
        spec_rows_ref(JG.rec_defs(jcfg))
    assert spec_rows_port(TG.rec_cache_defs(tcfg, 3)) == \
        spec_rows_ref(JG.rec_cache_defs(jcfg, 3))


def _rec_prefill_then_decode(jcfg, tcfg, S, steps, seed):
    """A full sequence of S tokens, then ``steps`` decode tokens from one
    random conv ring and state handed to both: outputs and caches compared
    at every step."""
    pj, pt = both(perturb(jax_init_params(JG.rec_defs(jcfg),
                                          jax.random.key(seed)), seed))
    B = 2
    x = _np(B, S + steps, jcfg.d_model, seed=seed + 1)
    yj, _ = JG.rec_apply(jcfg, pj, jnp.asarray(x[:, :S]), JaxSharder())
    yt, ct = TG.rec_apply(tcfg, pt, torch.from_numpy(x[:, :S]), Sharder())
    assert ct is None
    close(yt, yj)
    rng = np.random.default_rng(seed + 2)
    cache = {"conv": rng.standard_normal(
        (B, jcfg.ssm_conv - 1, jcfg.lru_width)).astype(np.float32),
        "state": rng.standard_normal((B, jcfg.lru_width)).astype(np.float32)}
    cj = {k: jnp.asarray(v) for k, v in cache.items()}
    ct = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    for t in range(steps):
        xs = x[:, S + t:S + t + 1]
        yj, cj = JG.rec_apply(jcfg, pj, jnp.asarray(xs), JaxSharder(),
                              cache=cj)
        yt, ct2 = TG.rec_apply(tcfg, pt, torch.from_numpy(xs), Sharder(),
                               cache=ct)
        assert ct2 is ct                           # written in place
        close(yt, yj)
        close(ct["conv"], cj["conv"])
        close(ct["state"], cj["state"])


@pytest.mark.parametrize("S", [16, 5])
def test_rec_block_prefill_and_decode_match_reference(S):
    """The smoke config's recurrent block (lru 64, conv 4): the full
    sequence, then three decode steps through the conv ring and state."""
    jcfg, tcfg = _cfgs()
    _rec_prefill_then_decode(jcfg, tcfg, S, 3, 11)


def test_rec_block_at_full_width_matches_reference():
    """recurrentgemma-9b's recurrent block at its published width (d_model
    and lru 4096) in f32: 16 tokens, then one decode step."""
    jcfg = jax_get_config(ARCH).replace(compute_dtype=jnp.float32)
    tcfg = get_config(ARCH).replace(compute_dtype=torch.float32)
    _rec_prefill_then_decode(jcfg, tcfg, 16, 1, 12)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_cache_and_batch_defs_match_reference(smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(
        ARCH))
    tb = build_model((smoke_config if smoke else get_config)(ARCH))
    assert spec_rows_port(tb.param_defs) == spec_rows_ref(jb.param_defs)
    for n in (544, 5):                   # the window's ring: min(window, n)
        assert spec_rows_port(tb.cache_defs(4, n)) == \
            spec_rows_ref(jb.cache_defs(4, n))
    for kind in ("prefill", "decode"):
        assert spec_rows_port(tb.batch_defs(ShapeConfig("serve", 512, 4,
                                                        kind))) == \
            spec_rows_ref(jb.batch_defs(JaxShape("serve", 512, 4, kind)))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    if not smoke:
        assert 10.3e9 < param_count(tb.param_defs) < 10.5e9
        assert set(tb.param_defs) >= {"tri", "tail0", "tail1"}


# ------------------------------------------------------- the whole model
def _models(seed=5, bf16=False):
    jcfg, tcfg = _cfgs(bf16=bf16)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B_SERVE, S_SERVE)).astype(np.int32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prefill_logits_match_reference(bf16):
    """16 tokens, twice the smoke window of 8."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16)
    lj, _ = jax.jit(jax_prefill(jb))(pj, {"tokens": jnp.asarray(tokens)})
    before = FK.launches
    lt, ct = make_prefill_step(tb)(pt, {"tokens": torch.from_numpy(tokens)})
    assert FK.launches == before                  # the CPU takes no kernel
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == S_SERVE
    assert bool(torch.isfinite(lt.float()).all())
    match(lt, lj, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_decode_logits_match_reference_every_step(bf16):
    """16 steps: the window's ring of 8 wraps twice."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    assert ct["tri"]["sub2"]["k"].shape[2] == 8          # the ring
    dec_j, dec_t = jax.jit(jax_decode(jb)), make_decode_step(tb)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok)})
        lt, ct = dec_t(pt, ct, {"token": torch.from_numpy(tok)})
        match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    # the RG-LRU state stays f32 whatever the compute dtype
    assert ct["tri"]["sub0"]["state"].dtype == torch.float32
    if bf16:
        assert rel_l2(ct["tri"]["sub0"]["state"],
                      cj["tri"]["sub0"]["state"]) <= BF16_TOL
    else:
        close(ct["tri"]["sub0"]["state"], cj["tri"]["sub0"]["state"])
    match(ct["tail1"]["conv"], cj["tail1"]["conv"], bf16)
    match(ct["tri"]["sub2"]["v"], cj["tri"]["sub2"]["v"], bf16)


def test_decode_replay_matches_prefill():
    """tests/test_serve_consistency.py's property on the port: replaying a
    prompt of 16 tokens, longer than the window of 8, through decode gives
    the prefill's last-position logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens = _models(seed=6)
    assert S_SERVE > tcfg.window
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu")
    close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI for recurrentgemma --smoke (weights
    from key 0, prompts from numpy seed 0) against the port's ``generate``
    on the same weights and prompts: the same greedy tokens."""
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


def test_serve_cli_serves_recurrentgemma_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", "12", "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2
