"""Mamba-2 block: state-space duality (SSD), chunked algorithm (PyTorch port
of ``repro.models.mamba2``).

Follows the minimal SSD reference of [arXiv:2405.21060] (Listing 1): within
chunks the quadratic "attention-like" form, across chunks a linear state
recurrence. ``ssd_chunked`` is the plain PyTorch version; on the
full-sequence path ``mamba_apply`` goes through ``kernels/ssd_scan/ops.ssd``,
which launches the hand-written Hopper kernel for CUDA tensors and runs
``ssd_chunked`` for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (ParamSpec, apply_norm, norm_defs,
                                        residual)
from repro_torch.obs.spans import span, spanned


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_in, nheads, conv_dim


def mamba_defs(cfg) -> dict:
    d = cfg.d_model
    d_in, nheads, conv_dim = dims(cfg)
    return {
        "ln": norm_defs(cfg.norm_kind, d),
        # order: [z, x, B, C, dt]
        "in_proj": ParamSpec((d, 2 * d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state
                              + nheads), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), ("conv", "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((nheads,), ("heads_q",), init="zeros"),
        "D": ParamSpec((nheads,), ("heads_q",), init="ones"),
        "dt_bias": ParamSpec((nheads,), ("heads_q",), init="zeros"),
        "out_ln": {"scale": ParamSpec((d_in,), ("mlp",), init="ones")},
        "out_proj": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def mamba_cache_defs(cfg, batch: int) -> dict:
    d_in, nheads, conv_dim = dims(cfg)
    return {
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, conv_dim),
                          ("cache_batch", None, "cache_heads"),
                          init="zeros", dtype=cfg.compute_dtype),
        "ssm": ParamSpec((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                         ("cache_batch", "cache_heads", None, None),
                         init="zeros", dtype=torch.float32),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, i.e. logaddexp(x, 0). torch's softplus returns x
    itself above its threshold of 20, where log1p(exp(-x)) < 2.1e-9 is below
    half an f32 ulp of x: the same f32 result."""
    return F.softplus(x, beta=1, threshold=20)


def _segsum(a):
    """a [..., q] -> [..., q, q] lower-tri cumulative sums: sum_{j<i<=k} a_i.
    -inf above the diagonal, so exp() of it is exactly 0 there (dividing
    exp(cs_i) by exp(cs_j) instead would overflow)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD over a full sequence.

    x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative),
    Bm/Cm [B,S,G,N]. Returns (y [B,S,H,P], final_state [B,H,P,N]).

    The reference's three- and four-operand einsums are written here as
    pairwise contractions in a fixed order, so no intermediate grows past
    the [B,nc,H,Q,Q] score tensor; the sums agree with the reference within
    f32 rounding, not bit for bit.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    xb = (x * dt[..., None]).reshape(Bsz, nc, Q, H, P).float()
    Bc = Bm.reshape(Bsz, nc, Q, G, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, G, N).float()
    Bh = torch.repeat_interleave(Bc, rep, dim=3)           # [B,nc,Q,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    dA = (dt * A[None, None, :]).reshape(Bsz, nc, Q, H)
    dA = torch.movedim(dA, -1, 1)                          # [B,H,nc,Q]
    dA_cs = torch.cumsum(dA, dim=-1)

    # intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(dA))                             # [B,H,nc,Q,Q]
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh) * L
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xb)

    # chunk states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)      # [B,H,nc,Q]
    xdec = xb * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bcshn,bcshp->bchpn", Bh, xdec)

    # inter-chunk recurrence (small quadratic over #chunks)
    if init_state is None:
        init_state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                                 device=x.device)
    states = torch.cat([init_state[:, None], states], dim=1)  # [B,nc+1,...]
    chunk_decay = dA_cs[..., -1]                           # [B,H,nc]
    dc = torch.exp(_segsum(F.pad(chunk_decay, (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # inter-chunk contribution
    state_decay_out = torch.exp(dA_cs)                     # [B,H,nc,Q]
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) \
        * state_decay_out.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), final_state


def _causal_conv(seq, w, b, state=None, act: bool = True):
    """Depthwise causal conv. seq [B,S,C], w [K,C]. Returns (out, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((seq.shape[0], K - 1, seq.shape[2]),
                          dtype=seq.dtype, device=seq.device)
    else:
        pad = state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    # Python's sum from 0, tap by tap: the reference's order
    out = sum(full[:, i:i + seq.shape[1]] * w[i][None, None] for i in range(K))
    out = out + b[None, None]
    return (F.silu(out) if act else out), full[:, -(K - 1):]


@spanned("model.mixer")
def mamba_apply(cfg, p, x, sh, *, cache=None, **_):
    """Full-seq when cache is None; single-token recurrence otherwise.
    -> (x + out, the cache a decode step continues from, {"conv", "ssm"}):
    in full-seq mode the conv's last ssm_conv - 1 inputs (a view of the
    conv's whole input) and SSD's final state; in decode the updated
    ones. The residual add is ``modules.residual``."""
    B, S, d = x.shape
    d_in, nheads, conv_dim = dims(cfg)
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    with span("model.mixer.norm"):
        h = apply_norm(cfg.norm_kind, p["ln"], x, cfg.norm_eps)
    zxbcdt = sh.dot(h, p["in_proj"].to(h.dtype))
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + conv_dim]
    dt_raw = zxbcdt[..., -nheads:]
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if cache is None:
        with span("model.mixer.conv"):
            xBC, conv_tail = _causal_conv(xBC, p["conv_w"].to(h.dtype),
                                          p["conv_b"].to(h.dtype))
        xs = xBC[..., :d_in].reshape(B, S, nheads, cfg.ssm_head_dim)
        Bm = xBC[..., d_in:d_in + G * N].reshape(B, S, G, N)
        Cm = xBC[..., d_in + G * N:].reshape(B, S, G, N)
        xs = sh(xs, "batch", None, "act_heads", None)
        dt = sh(dt, "batch", None, "act_heads")
        from repro_torch.kernels.ssd_scan.ops import ssd
        with span("model.mixer.ssd"):
            y, state = ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
            y = y + xs * p["D"].to(xs.dtype)[None, None, :, None]
        new_cache = {"conv": conv_tail, "ssm": state}
    else:
        # decode: conv ring + linear state update
        conv_in = torch.cat([cache["conv"].to(h.dtype), xBC],
                            dim=1)                          # [B,K,convdim]
        w = p["conv_w"].to(h.dtype)
        conv_out = F.silu(
            (conv_in * w[None]).sum(dim=1, keepdim=True)
            + p["conv_b"].to(h.dtype)[None, None])
        xs = conv_out[..., :d_in].reshape(B, 1, nheads, cfg.ssm_head_dim)
        Bm = conv_out[..., d_in:d_in + G * N].reshape(B, 1, G, N)
        Cm = conv_out[..., d_in + G * N:].reshape(B, 1, G, N)
        rep = nheads // G
        Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1).float()  # [B,H,N]
        Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1).float()
        dt1 = dt[:, 0]                                      # [B,H]
        dA = torch.exp(dt1 * A[None])                       # [B,H]
        xf = xs[:, 0].float()                               # [B,H,P]
        new_ssm = (cache["ssm"] * dA[..., None, None]
                   + torch.einsum("bhp,bhn->bhpn", xf * dt1[..., None], Bh))
        y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)[:, None]
        y = y.to(xs.dtype) + xs * p["D"].to(xs.dtype)[None, None, :, None]
        new_cache = {"conv": conv_in[:, 1:].to(cache["conv"].dtype),
                     "ssm": new_ssm}

    y = y.reshape(B, S, d_in)
    with span("model.mixer.gate"):
        y = apply_norm("rms", p["out_ln"], y * F.silu(z), cfg.norm_eps)
    out = sh.dot(y, p["out_proj"].to(h.dtype))
    return residual(cfg, x, sh(out, "batch", "seq", "act_embed")), new_cache
