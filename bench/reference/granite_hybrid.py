"""Plain reference of IBM Granite 4.0-H (GraniteMoeHybrid): a stack of
pre-norm layers whose mixer is Mamba-2 or attention as ``layer_types``
says, each followed by a pre-norm MoE with a shared expert, with the muP
multipliers:

  x = embed(tokens) * embedding_multiplier
  x = x + residual_multiplier * mixer(rms(x))
  x = x + residual_multiplier * (moe(rms(x)) + shared(rms(x)))
  logits = rms(x) @ embed^T / logits_scaling

Mamba-2: ``in_proj`` gives z, xBC and dt; xBC goes through a causal
depthwise conv with bias and SiLU; SSD (the chunked algorithm of
arXiv:2405.21060, Listing 1) with A = -exp(A_log), dt = softplus(dt +
dt_bias), plus the D skip; then rms(y * silu(z)) over all of d_inner and
``out_proj``. Attention: GQA with no positional embedding, softmax scale
``attention_multiplier``. The router takes the top k of its logits and a
softmax over those k; each request's entries past an expert's capacity
(over all routed experts, token-major, choices minor) are dropped, as
``deepseek_v2.py`` computes them. Only the experts of the file's share
(``expert_share``, ``num_local_experts``) are here: the others' entries
add nothing, as in the program. Reads the configuration file's published
keys and the weights by their flat names (stacked by kind: "mamba",
"attn" over the layers of each mixer, "moe" over all layers). Departures
from the published model are the file's ``as_published`` and
``architecture`` entries: the expert share, and the chunk of 128 (SSD's
result does not depend on it)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from _plain import causal_attention, rms, strict_f32, swiglu


def sizes(c: dict) -> dict:
    L, d = c["num_hidden_layers"], c["hidden_size"]
    return {"L": L, "d": d, "kinds": c["layer_types"][:L],
            "H": c["num_attention_heads"], "Hk": c["num_key_value_heads"],
            "D": d // c["num_attention_heads"],
            "E": c["expert_share"]["routed"],
            "first": c["expert_share"]["first_held"],
            "Eh": c["num_local_experts"], "k": c["num_experts_per_tok"],
            "f": c["intermediate_size"], "fs": c["shared_intermediate_size"],
            "mh": c["mamba_n_heads"], "mp": c["mamba_d_head"],
            "N": c["mamba_d_state"], "G": c["mamba_n_groups"],
            "K": c["mamba_d_conv"], "Q": c["mamba_chunk_size"],
            "d_in": c["mamba_expand"] * d, "V": c["vocab_size"],
            "eps": c["rms_norm_eps"], "emb": c["embedding_multiplier"],
            "res": c["residual_multiplier"], "div": c["logits_scaling"],
            "scale": c["attention_multiplier"]}


def capacity(c: dict, S: int) -> int:
    """Slots an expert has in one request of S tokens (over all routed
    experts: the deployment's)."""
    cap, z = c["capacity"], sizes(c)
    n = math.ceil(S * z["k"] / z["E"] * cap["factor"])
    return max(cap["align"], (n + cap["align"] - 1) // cap["align"]
               * cap["align"])


def structure(c: dict) -> dict:
    """Sizes for the benchmark's arithmetic. ``matmul_params`` counts the
    routed experts at top k x held / routed (the entries held here on
    average); ``moe.experts`` is the count routed over (the capacity's),
    ``moe.held`` the experts here; ``ssm`` gives the SSD's shapes."""
    z = sizes(c)
    d, H, Hk, D = z["d"], z["H"], z["Hk"], z["D"]
    n_m = z["kinds"].count("mamba")
    n_a = z["kinds"].count("attention")
    mamba = d * (2 * z["d_in"] + 2 * z["G"] * z["N"] + z["mh"]) \
        + z["d_in"] * d
    attn = d * H * D + 2 * d * Hk * D + H * D * d
    moe = d * z["E"] + 3 * d * z["f"] * z["k"] * z["Eh"] / z["E"] \
        + 3 * d * z["fs"]
    return {"matmul_params": n_m * mamba + n_a * attn + z["L"] * moe,
            "head_params": d * z["V"],
            "attention": [{"layers": n_a, "heads": H, "kv_heads": Hk,
                           "d_qk": D, "d_v": D}],
            "moe": {"layers": z["L"], "experts": z["E"], "held": z["Eh"],
                    "top_k": z["k"],
                    "capacity_factor": c["capacity"]["factor"],
                    "align": c["capacity"]["align"]},
            "ssm": {"layers": n_m, "heads": z["mh"], "head_dim": z["mp"],
                    "state": z["N"], "groups": z["G"], "chunk": z["Q"]},
            "vocab": z["V"]}


def _segsum(a):
    """a [..., T] -> [..., T, T]: sum of a over (j, i] at [i, j], -inf
    above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """SSD, Listing 1 of arXiv:2405.21060: x [n,S,H,P], dt [n,S,H], A [H],
    B and C [n,S,G,N] -> y [n,S,H,P] (zero initial state). A sequence
    that is not a whole number of chunks is padded at its end with dt 0
    (no decay, no input), which leaves every earlier output as it is."""
    n, S, H, P = x.shape
    G = B.shape[2]
    Q = min(chunk, S)
    pad = -S % Q
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
        return ssd(x, dt, A, B, C, chunk)[:, :S]
    c = S // Q
    xc = (x * dt[..., None]).reshape(n, c, Q, H, P)
    a = (dt * A).reshape(n, c, Q, H).permute(0, 3, 1, 2)         # n,H,c,Q
    Bh = B.reshape(n, c, Q, G, -1).repeat_interleave(H // G, 3)
    Ch = C.reshape(n, c, Q, G, -1).repeat_interleave(H // G, 3)
    a_cs = torch.cumsum(a, -1)
    # within each chunk: the quadratic form
    cb = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh) * torch.exp(_segsum(a))
    y = torch.einsum("bhcls,bcshp->bclhp", cb, xc)
    # each chunk's state, then the recurrence over chunks
    decay = torch.exp(a_cs[..., -1:] - a_cs)                     # n,H,c,Q
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, xc)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    across = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))   # n,H,c+1,c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    # each chunk's start state, read out
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states,
                         torch.exp(a_cs))
    return y.reshape(n, S, H, P)


def _mamba(z, p, x, prec):
    n, S, _ = x.shape
    d_in, G, N, H = z["d_in"], z["G"], z["N"], z["mh"]
    h = rms(x, p("ln.scale"), z["eps"])
    zxbcdt = prec.mm(h, p("in_proj"))
    gate = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt = F.softplus(zxbcdt[..., -H:] + p("dt_bias"))
    w = p("conv_w")                                              # [K, ch]
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(K))
                 + p("conv_b"))
    xs = xbc[..., :d_in].reshape(n, S, H, z["mp"])
    Bm = xbc[..., d_in:d_in + G * N].reshape(n, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(n, S, G, N)
    y = ssd(xs, dt, -torch.exp(p("A_log")), Bm, Cm, z["Q"])
    y = (y + xs * p("D")[:, None]).reshape(n, S, d_in)
    y = rms(y * F.silu(gate), p("out_ln.scale"), z["eps"])
    return x + z["res"] * prec.mm(y, p("out_proj"))


def _attention(z, p, x, prec):
    n, S, _ = x.shape
    H, Hk, D = z["H"], z["Hk"], z["D"]
    h = rms(x, p("ln.scale"), z["eps"])
    q = prec.mm(h, p("wq")).view(n, S, H, D)
    k = prec.mm(h, p("wk")).view(n, S, Hk, D)
    v = prec.mm(h, p("wv")).view(n, S, Hk, D)
    o = causal_attention(q, k, v, z["scale"]).reshape(n, S, H * D)
    return x + z["res"] * prec.mm(o, p("wo"))


def _moe(z, c, p, x, prec):
    n, S, d = x.shape
    E, k = z["E"], z["k"]
    h = rms(x, p("ln.scale"), z["eps"])
    top = torch.topk(prec.mm(h, p("router")), k, -1)              # [n, S, k]
    wt, ex = torch.softmax(top.values, -1), top.indices
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
    keep = (rank < capacity(c, S)).view(n * S, k)
    out = torch.zeros(n * S, d, device=x.device)
    rows = h.reshape(n * S, d)
    tok = torch.arange(n * S, device=x.device)[:, None].expand(n * S, k)
    ex, wt = ex.reshape(n * S, k), wt.reshape(n * S, k)
    wg, wu, wd = (p.raw(name) for name in ("w_gate", "w_up", "w_down"))
    for j in range(z["Eh"]):
        sel = (ex == z["first"] + j) & keep
        t = tok[sel]
        if t.numel() == 0:
            continue
        y = swiglu(prec, rows[t], wg[j].float(), wu[j].float(),
                   wd[j].float())
        out.index_add_(0, t, y * wt[sel][:, None])
    out = out.view(n, S, d) + swiglu(prec, h, p("shared.w_gate"),
                                     p("shared.w_up"), p("shared.w_down"))
    return x + z["res"] * out


def forward(w: dict, c: dict, tokens: torch.Tensor, prec) -> torch.Tensor:
    """Logits [n, V] f32 at the last position of each prompt in tokens
    [n, S]."""
    strict_f32()
    z = sizes(c)

    def at(prefix, i):
        def raw(name):
            return w[f"{prefix}.{name}"][i]

        def p(name):
            return raw(name).float()
        p.raw = raw
        return p
    x = w["embed"][tokens.long()].float() * z["emb"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(z["kinds"]):
        j = seen[kind]
        seen[kind] += 1
        if kind == "mamba":
            x = _mamba(z, at("mamba", j), x, prec)
        else:
            x = _attention(z, at("attn", j), x, prec)
        x = _moe(z, c, at("moe", i), x, prec)
    last = rms(x[:, -1], w["final_ln.scale"], z["eps"])
    return prec.mm(last, w["embed"].float().T) / z["div"]
