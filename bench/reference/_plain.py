"""Plain PyTorch pieces the references share: float32 throughout, TF32
off, no kernel, cache or batching trick. ``Exact`` multiplies in float32;
``Fp8`` is the control: every matrix product of a linear layer with its
operands rounded to float8 e4m3 (each activation row and each weight
column scaled to the format's range), as an fp8 serving path would."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# query rows x keys x heads of f32 scores held at once
SCORE_BLOCK = 1 << 28
FP8_MAX = 448.0


def strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Exact:
    name = "f32"

    def mm(self, x, w):
        return x @ w


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Fp8:
    name = "fp8"

    def mm(self, x, w):
        return fp8_round(x, -1) @ fp8_round(w, -2)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope_freqs(base: float, rot: int) -> torch.Tensor:
    """The rot/2 inverse frequencies of a rotary embedding, float64."""
    return 1.0 / base ** (torch.arange(0, rot, 2, dtype=torch.float64) / rot)


def rope(x: torch.Tensor, base: float, rot: int,
         inv: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary embedding of x [n, S, H, D] at positions 0..S-1 on its first
    ``rot`` dims, pairs (i, i + rot/2), at the inverse frequencies ``inv``
    (``rope_freqs(base, rot)`` if None)."""
    S = x.shape[1]
    inv = (rope_freqs(base, rot) if inv is None else inv).to(x.device)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b, rest = x[..., :rot // 2], x[..., rot // 2:rot], x[..., rot:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], -1)


def causal_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """softmax(q.k * scale) v over the keys at or before each query, scale
    1 / sqrt(D) if None. q
    [n, S, H, D], k [n, S, Hk, D], v [n, S, Hk, Dv]; query head h reads
    key head h // (H / Hk). Query rows go in blocks, each against the keys
    up to its end. -> [n, S, H, Dv]."""
    n, S, H, D = q.shape
    Hk = k.shape[2]
    g = H // Hk
    qh = q.permute(0, 2, 1, 3).reshape(n, Hk, g, S, D)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    out = torch.empty(n, Hk, g, S, v.shape[-1], device=q.device)
    blk = max(1, SCORE_BLOCK // (n * H * S))
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    for a in range(0, S, blk):
        b = min(S, a + blk)
        s = torch.einsum("nkgqd,nksd->nkgqs", qh[:, :, :, a:b],
                         kh[:, :, :b]) * scale
        mask = torch.arange(b, device=q.device)[None, :] \
            > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, :, :, a:b] = torch.einsum("nkgqs,nksd->nkgqd",
                                         torch.softmax(s, -1), vh[:, :, :b])
    return out.reshape(n, H, S, -1).permute(0, 2, 1, 3)


def swiglu(prec, h, wg, wu, wd):
    return prec.mm(F.silu(prec.mm(h, wg)) * prec.mm(h, wu), wd)
