"""Public ssd_scan entry point in model layout: the CUDA kernel for CUDA
tensors, the plain chunked SSD for CPU tensors, nothing else."""
from __future__ import annotations

from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ssd_scan as K
from repro_torch.models.mamba2 import ssd_chunked


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x [B,S,H,P], dt [B,S,H] (post-softplus), A [H], Bm/Cm [B,S,G,N].
    Returns (y [B,S,H,P] in x's dtype, state [B,H,P,N] f32), in chunks of
    min(chunk, S) rows; S must divide by that."""
    Q = min(chunk, x.shape[1])
    if x.shape[1] % Q:
        raise ValueError(f"sequence {x.shape[1]} does not divide into "
                         f"chunks of {Q}")
    if kernels.on_card(x):
        return K.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                          Bm.contiguous(), Cm.contiguous(), chunk=Q)
    if x.device.type != "cpu":
        raise ValueError(f"ssd has no path for {x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, Q)
