"""Plain reference of DeepSeek-V2(-Lite): multi-head latent attention (q
full rank; k and v up-projected from a normed 512-wide latent, a 64-dim
rotary key shared by the heads), a dense first layer, then MoE layers
with a softmax router, the top k experts a token with renormalised
weights, shared experts, and a capacity per expert in each request. The
rotary key and the softmax scale follow the file's ``rope_scaling`` group
(YaRN, as DeepSeek-V2's published modelling code computes it). Reads the
configuration file's published keys (and its ``capacity`` group) and the
weights by their flat names. Departures from the published model are
the file's ``as_published`` and ``architecture`` entries."""
from __future__ import annotations

import math

import torch

from _plain import (causal_attention, rms, rope, rope_freqs, strict_f32,
                    swiglu)


def sizes(c: dict) -> dict:
    return {"L": c["num_hidden_layers"], "d": c["hidden_size"],
            "H": c["num_attention_heads"], "nope": c["qk_nope_head_dim"],
            "rope": c["qk_rope_head_dim"], "vd": c["v_head_dim"],
            "r": c["kv_lora_rank"], "F": c["intermediate_size"],
            "E": c["n_routed_experts"], "k": c["num_experts_per_tok"],
            "f": c["moe_intermediate_size"], "shared": c["n_shared_experts"],
            "dense": c["first_k_dense_replace"], "V": c["vocab_size"],
            "eps": c["rms_norm_eps"], "base": c["rope_theta"]}


def _yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rotary(c: dict) -> dict:
    """The rotary key's inverse frequencies, the gain on its cos and sin,
    and the softmax scale, from ``rope_scaling``: YaRN blends each
    frequency with itself over ``factor`` on a ramp between the dims that
    turn ``beta_fast`` and ``beta_slow`` times in the original context,
    and multiplies the scale by mscale(factor, mscale_all_dim)^2; plain
    RoPE where the group is null."""
    z = sizes(c)
    rd, base = z["rope"], z["base"]
    inv = rope_freqs(base, rd)
    out = {"inv": inv, "gain": 1.0,
           "scale": 1.0 / math.sqrt(z["nope"] + rd)}
    rs = c["rope_scaling"]
    if rs is None:
        return out
    assert rs["type"] == "yarn", rs["type"]
    f = rs["factor"]

    def turns(rot):
        return rd * math.log(rs["original_max_position_embeddings"]
                             / (rot * 2 * math.pi)) / (2 * math.log(base))
    lo = max(math.floor(turns(rs["beta_fast"])), 0)
    hi = min(math.ceil(turns(rs["beta_slow"])), rd - 1)
    hi = hi + 0.001 if lo == hi else hi
    ramp = ((torch.arange(rd // 2, dtype=torch.float64) - lo)
            / (hi - lo)).clamp(0, 1)
    out["inv"] = inv / f * ramp + inv * (1 - ramp)
    out["gain"] = _yarn_mscale(f, rs["mscale"]) \
        / _yarn_mscale(f, rs["mscale_all_dim"])
    if rs["mscale_all_dim"]:
        out["scale"] *= _yarn_mscale(f, rs["mscale_all_dim"]) ** 2
    return out


def capacity(c: dict, S: int) -> int:
    cap = c["capacity"]
    z = sizes(c)
    n = math.ceil(S * z["k"] / z["E"] * cap["factor"])
    return max(cap["align"], (n + cap["align"] - 1) // cap["align"]
               * cap["align"])


def structure(c: dict) -> dict:
    z = sizes(c)
    d, H = z["d"], z["H"]
    attn = (d * H * (z["nope"] + z["rope"]) + d * (z["r"] + z["rope"])
            + z["r"] * H * z["nope"] + z["r"] * H * z["vd"] + H * z["vd"] * d)
    moe = d * z["E"] + (z["k"] + z["shared"]) * 3 * d * z["f"]
    n_moe = z["L"] - z["dense"]
    return {"matmul_params": z["L"] * attn + z["dense"] * 3 * d * z["F"]
            + n_moe * moe,
            "head_params": d * z["V"],
            "attention": [{"layers": z["L"], "heads": H, "kv_heads": H,
                           "d_qk": z["nope"] + z["rope"], "d_v": z["vd"]}],
            "moe": {"layers": n_moe, "experts": z["E"], "top_k": z["k"],
                    "capacity_factor": c["capacity"]["factor"],
                    "align": c["capacity"]["align"]},
            "vocab": z["V"]}


def _mla(z, p, x, prec):
    n, S, _ = x.shape
    H, nope, rd, r = z["H"], z["nope"], z["rope"], z["r"]
    h = rms(x, p("ln.scale"), z["eps"])
    q = prec.mm(h, p("wq")).view(n, S, H, nope + rd)
    rot = z["rotary"]
    q = torch.cat([q[..., :nope],
                   rope(q[..., nope:], z["base"], rd, rot["inv"])
                   * rot["gain"]], -1)
    ckv = prec.mm(h, p("w_dkv"))
    kr = rope(ckv[..., None, r:], z["base"], rd, rot["inv"]) * rot["gain"]
    ckv = rms(ckv[..., :r], p("kv_ln.scale"), z["eps"])
    k = torch.cat([prec.mm(ckv, p("w_uk")).view(n, S, H, nope),
                   kr.expand(n, S, H, rd)], -1)
    v = prec.mm(ckv, p("w_uv")).view(n, S, H, z["vd"])
    o = causal_attention(q, k, v, rot["scale"]).reshape(n, S, H * z["vd"])
    return x + prec.mm(o, p("wo"))


def _moe(z, c, p, x, prec):
    n, S, d = x.shape
    E, k = z["E"], z["k"]
    h = rms(x, p("ln.scale"), z["eps"])
    probs = torch.softmax(prec.mm(h, p("router")), -1)
    wt, ex = torch.topk(probs, k, -1)                         # [n, S, k]
    wt = wt / wt.sum(-1, keepdim=True)
    # each entry's rank among the entries of its request and expert, in
    # token-major, choice-minor order; past the capacity it is dropped
    key = (ex + E * torch.arange(n, device=x.device)[:, None, None]
           ).reshape(-1)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n * E)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel(), device=x.device) \
        - start[key[order]]
    keep = (rank < capacity(c, S)).view(n, S, k)
    out = torch.zeros(n * S, d, device=x.device)
    rows = h.reshape(n * S, d)
    tok = torch.arange(n * S, device=x.device)[:, None].expand(n * S, k)
    ex, wt, keep = ex.reshape(n * S, k), wt.reshape(n * S, k), \
        keep.reshape(n * S, k)
    wg, wu, wd = (p.raw(name) for name in ("w_gate", "w_up", "w_down"))
    for e in range(E):
        sel = (ex == e) & keep
        t = tok[sel]
        if t.numel() == 0:
            continue
        y = swiglu(prec, rows[t], wg[e].float(), wu[e].float(),
                   wd[e].float())
        out.index_add_(0, t, y * wt[sel][:, None])
    out = out.view(n, S, d) + swiglu(prec, h, p("shared.w_gate"),
                                     p("shared.w_up"), p("shared.w_down"))
    return x + out


def forward(w: dict, c: dict, tokens: torch.Tensor, prec) -> torch.Tensor:
    """Logits [n, V] f32 at the last position of each prompt in tokens
    [n, S]."""
    strict_f32()
    z = sizes(c)
    z["rotary"] = rotary(c)
    x = w["embed"][tokens.long()].float()

    def at(prefix, i=None):
        def raw(name):
            t = w[f"{prefix}.{name}"]
            return t if i is None else t[i]

        def p(name):
            return raw(name).float()
        p.raw = raw
        return p
    x = _mla(z, at("layer0.attn"), x, prec)
    mlp = at("layer0.mlp")
    h = rms(x, mlp("ln.scale"), z["eps"])
    x = x + swiglu(prec, h, mlp("w_gate"), mlp("w_up"), mlp("w_down"))
    for i in range(z["L"] - z["dense"]):
        x = _mla(z, at("layers.attn", i), x, prec)
        x = _moe(z, c, at("layers.mlp", i), x, prec)
    last = rms(x[:, -1], w["final_ln.scale"], z["eps"])
    return prec.mm(last, w["lm_head"].float())
