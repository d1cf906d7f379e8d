"""The references agree with the port's CPU path at smoke width, in
float32, on the same weights and prompts (the harness's draw), capacity
drops included; and the fp8 control lies far from both."""
import json
import math

import pytest
import torch

import _plain
import _smoke
from harness import cell as C
from harness import weights
from repro_torch.launch import serve, steps
from repro_torch.models import model


@pytest.mark.parametrize("name", sorted(_smoke.SMOKE))
def test_reference_matches_the_port(name):
    conf = _smoke.smoke_config(name, "float32")
    cfg = C.program_config(conf)
    ref = C.reference(C.BENCH, conf["reference"])
    bundle = model.build_model(cfg)
    params, flat = weights.draw(bundle.param_defs, 11, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(3)
    for B, S in ((4, 32), (2, 64)):
        toks = torch.randint(0, 512, (B, S), generator=gen).int()
        got, _ = steps.make_prefill_step(bundle)(
            params, serve.prefill_batch(bundle, toks))
        want = ref.forward(flat, conf, toks, _plain.Exact())
        err = (got[:, -1] - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(err.max()) < 1e-5
        ctl = ref.forward(flat, conf, toks, _plain.Fp8())
        assert float(((ctl - want).norm(dim=-1)
                      / want.norm(dim=-1)).min()) > 0.05


def test_drops_follow_the_capacity():
    """A request whose tokens all choose the same experts keeps the first
    ``capacity`` entries of each and drops the rest."""
    conf = _smoke.smoke_config("deepseek-v2-lite-16b", "float32")
    ref = C.reference(C.BENCH, conf["reference"])
    assert ref.capacity(conf, 32) == 16          # 32 x 2 / 8 x 1.5 -> 16
    assert ref.capacity(conf, 8) == 8


def test_rope_scaling_follows_yarn():
    """At the file's factor 1 the rotary key and the softmax scale are
    plain RoPE's; at the published factor 40 they are YaRN's, as
    DeepSeek-V2's modelling code computes them."""
    conf = json.loads((C.BENCH / "configs" / "deepseek-v2-lite-16b.json")
                      .read_text())
    ref = C.reference(C.BENCH, conf["reference"])
    plain = _plain.rope_freqs(conf["rope_theta"], conf["qk_rope_head_dim"])
    run = ref.rotary(conf)
    assert torch.allclose(run["inv"], plain, rtol=1e-15, atol=0)
    assert run["gain"] == 1.0 and run["scale"] == 1 / math.sqrt(192)
    pub = dict(conf, rope_scaling=dict(conf["rope_scaling"],
                                       **conf["as_published"]["rope_scaling"]))
    yarn = ref.rotary(pub)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert yarn["gain"] == 1.0
    assert yarn["scale"] == pytest.approx(m * m / math.sqrt(192), rel=1e-12)
    # the fast correction dim is 10, the slow one 23: frequencies below
    # the first are kept, those from the second on divided by the factor
    assert torch.equal(yarn["inv"][:11], plain[:11])
    assert torch.allclose(yarn["inv"][23:], plain[23:] / 40, rtol=1e-15)
    mid = slice(11, 23)
    assert (yarn["inv"][mid] < plain[mid]).all()
    assert (yarn["inv"][mid] > plain[mid] / 40).all()
