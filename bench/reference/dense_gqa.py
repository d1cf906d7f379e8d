"""Plain reference of a dense decoder with grouped-query attention
(GLM-4-9B): pre-norm RMSNorm layers, partial rotary on q and k, causal
attention with query heads grouped over the kv heads, a SwiGLU MLP, a
final RMSNorm and an untied head. Reads the configuration file's
published keys and the weights by their flat names (stacked over
layers). Departures from the published model are the file's
``as_published`` and ``architecture`` entries."""
from __future__ import annotations

import torch

from _plain import causal_attention, rms, rope, strict_f32, swiglu


def sizes(c: dict) -> dict:
    return {"L": c["num_layers"], "d": c["hidden_size"],
            "H": c["num_attention_heads"], "Hk": c["multi_query_group_num"],
            "D": c["kv_channels"], "F": c["ffn_hidden_size"],
            "V": c["padded_vocab_size"], "eps": c["layernorm_epsilon"],
            "rot": int(c["kv_channels"] * c["architecture"]["rotary_fraction"])
            // 2 * 2,
            "base": c["architecture"]["rope_base"] * c.get("rope_ratio", 1)}


def structure(c: dict) -> dict:
    z = sizes(c)
    d, H, Hk, D = z["d"], z["H"], z["Hk"], z["D"]
    layer = d * H * D + 2 * d * Hk * D + H * D * d + 3 * d * z["F"]
    return {"matmul_params": z["L"] * layer, "head_params": d * z["V"],
            "attention": [{"layers": z["L"], "heads": H, "kv_heads": Hk,
                           "d_qk": D, "d_v": D}],
            "moe": None, "vocab": z["V"]}


def forward(w: dict, c: dict, tokens: torch.Tensor, prec) -> torch.Tensor:
    """Logits [n, V] f32 at the last position of each prompt in tokens
    [n, S]."""
    strict_f32()
    z = sizes(c)
    n, S = tokens.shape
    H, Hk, D = z["H"], z["Hk"], z["D"]
    x = w["embed"][tokens.long()].float()
    for i in range(z["L"]):
        def p(name):
            return w[f"layers.{name}"][i].float()
        h = rms(x, p("attn.ln.scale"), z["eps"])
        q = prec.mm(h, p("attn.wq")).view(n, S, H, D)
        k = prec.mm(h, p("attn.wk")).view(n, S, Hk, D)
        v = prec.mm(h, p("attn.wv")).view(n, S, Hk, D)
        q, k = rope(q, z["base"], z["rot"]), rope(k, z["base"], z["rot"])
        o = causal_attention(q, k, v).reshape(n, S, H * D)
        x = x + prec.mm(o, p("attn.wo"))
        h = rms(x, p("mlp.ln.scale"), z["eps"])
        x = x + swiglu(prec, h, p("mlp.w_gate"), p("mlp.w_up"),
                       p("mlp.w_down"))
    last = rms(x[:, -1], w["final_ln.scale"], z["eps"])
    return prec.mm(last, w["lm_head"].float())
