"""Plain PyTorch versions of ssd_scan: the model's chunked SSD
(``models/mamba2.ssd_chunked``, the CPU path of ``ops.ssd`` and what the
CUDA kernel is held against) and the token-by-token recurrence it must
match."""
from __future__ import annotations

import torch

# re-exported so kernel users get the plain version and the recurrence together
from repro_torch.models.mamba2 import ssd_chunked  # noqa: F401


def ssd_sequential(x, dt, A, Bm, Cm):
    """Token-by-token reference recurrence (the literal SSM definition)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()     # [B,H,P], [B,H]
        bt = torch.repeat_interleave(Bm[:, t].float(), rep, dim=1)
        ct = torch.repeat_interleave(Cm[:, t].float(), rep, dim=1)
        dA = torch.exp(dtt * A[None])                   # [B,H]
        state = (state * dA[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", xt * dtt[..., None], bt))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    return torch.stack(ys, dim=1), state
