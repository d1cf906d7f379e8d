"""The benchmark's own copy of the SSD work of one ``ssd_scan`` call, so
that later changes to the program do not move the yardstick: the least a
chunked SSD of one Mamba-2 layer needs, from the reference's ``ssm``
sizes (``bench/reference/<family>.py: structure``)."""
from __future__ import annotations

BF16 = 2


def work(ssm: dict, B: int, S: int, elem_bytes: int = BF16
         ) -> tuple[int, int]:
    """(flops, bytes) of one layer's SSD over B prompts of S tokens in
    chunks of Q = min(chunk, S): the causal triangle of C.B^T once a
    (request, group, chunk), and per (request, head, chunk) the triangle
    of the scores by x*dt, C.state and B^T.(x*dt) in full; x and y
    (``elem_bytes``), B and C (``elem_bytes``), dt, A and the final state
    (f32) read or written once."""
    H, P = ssm["heads"], ssm["head_dim"]
    N, G = ssm["state"], ssm["groups"]
    Q = min(ssm["chunk"], S)
    tri = Q * (Q + 1) // 2
    flops = B * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * elem_bytes
              + 4 * B * S * H + 4 * H
              + 2 * B * S * G * N * elem_bytes
              + 4 * B * H * P * N)
    return flops, nbytes
