"""Public ssd_scan entry point in model layout: the CUDA kernel for CUDA
tensors, a shape-only launch for meta tensors (the dry run's stand-in for
the card), the plain chunked SSD for CPU tensors, nothing else. DTensors
(a mesh's dry run) run the entry on their local shards, after
redistributing the inputs to a layout that is local to the kernel
(``_on_mesh``). ``work`` is the function's closed-form FLOPs and bytes, the
least it needs (every bound's numerator); ``model_work`` is what a step
analysis counts for a call: the FLOPs of ``ssd_chunked``, the model's own
algorithm, which the reference's program runs in the kernel's place."""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ssd_scan as K
from repro_torch.models.mamba2 import ssd_chunked


def work(x_shape, bc_shape, *, chunk: int, elem_bytes: int
         ) -> tuple[int, int]:
    """(flops, bytes) the function needs for x [B,S,H,P] and Bm/Cm
    [B,S,G,N]: the causal triangle of C.B^T once per (b, group, chunk), as
    it does not depend on the head; per (b*h, chunk) the triangle of
    S.(x*dt), and C.state and B^T.(x*dt) in full; each input read once,
    each output written once, at model layout (x, Bm, Cm and y in
    ``elem_bytes``, dt, A and the state in f32)."""
    B, S, H, P = x_shape
    G, N = bc_shape[2], bc_shape[3]
    Q = min(chunk, S)
    tri = Q * (Q + 1) // 2
    flops = B * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * elem_bytes          # x read, y written
              + 4 * B * S * H + 4 * H                 # dt, A
              + 2 * B * S * G * N * elem_bytes        # Bm, Cm
              + 4 * B * H * P * N)                    # state written
    return flops, nbytes


def model_work(x_shape, bc_shape, *, chunk: int, elem_bytes: int
               ) -> tuple[int, int]:
    """(flops, bytes) a step analysis counts for a call: the products of
    ``ssd_chunked`` (the reference's ``models/mamba2.py:ssd_chunked``) with
    B and C repeated to the heads, per (b, h, chunk) the full square of
    C.B^T and of the scores by x*dt, B^T.(x*dt) and C.state; the
    recurrence over the nc + 1 chunk states; the bytes are ``work``'s,
    what the kernel moves."""
    B, S, H, P = x_shape
    N = bc_shape[3]
    Q = min(chunk, S)
    nc = S // Q
    flops = 2 * B * H * (nc * Q * Q * (N + P) + 2 * nc * Q * P * N
                         + (nc + 1) ** 2 * P * N)
    return flops, work(x_shape, bc_shape, chunk=chunk,
                       elem_bytes=elem_bytes)[1]


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x [B,S,H,P], dt [B,S,H] (post-softplus), A [H], Bm/Cm [B,S,G,N].
    Returns (y [B,S,H,P] in x's dtype, state [B,H,P,N] f32), in chunks of
    min(chunk, S) rows; S must divide by that."""
    Q = min(chunk, x.shape[1])
    if x.shape[1] % Q:
        raise ValueError(f"sequence {x.shape[1]} does not divide into "
                         f"chunks of {Q}")
    if isinstance(x, DTensor):
        return _on_mesh(x, dt, A, Bm, Cm, chunk=Q)
    if kernels.kernel_route(x):
        args = [t.contiguous() for t in (x, dt, A, Bm, Cm)]
        with kernels.entry("ssd_scan", lambda: model_work(
                x.shape, Bm.shape, chunk=Q, elem_bytes=x.element_size())):
            return K.ssd_scan(*args, chunk=Q)
    if x.device.type != "cpu":
        raise ValueError(f"ssd has no path for {x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, Q)


def _on_mesh(x, dt, A, Bm, Cm, *, chunk: int):
    """The call on DTensors: on each mesh dim, a batch split of x is kept
    (dt, Bm and Cm take it too); a head split is kept where the heads
    share one group of B and C (dt and A take it, Bm and Cm are gathered
    whole); any other layout is gathered first. The entry then runs on the
    local shards; y has x's layout, the state its batch or head split."""
    mesh = x.device_mesh
    one_group = Bm.shape[2] == 1
    lay = {"x": [], "dt": [], "A": [], "bc": [], "state": []}
    for p in x.placements:
        if p == Shard(0):
            got = (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0))
        elif p == Shard(2) and one_group:
            got = (Shard(2), Shard(2), Shard(0), Replicate(), Shard(1))
        else:
            got = (Replicate(),) * 5
        for key, g in zip(lay, got):
            lay[key].append(g)
    x = x.redistribute(mesh, lay["x"])
    dt = dt.redistribute(mesh, lay["dt"])
    A = A.redistribute(mesh, lay["A"])
    Bm, Cm = (t.redistribute(mesh, lay["bc"]) for t in (Bm, Cm))
    # an operand replicated where x is split takes a gradient summed over
    # that split: A over the batch, B and C over the heads
    part = [Partial() if p.is_shard() else Replicate() for p in lay["x"]]
    ag = [q if p.is_shard(2) else r for p, q, r in zip(lay["x"], lay["A"],
                                                      part)]
    bcg = [q if p.is_shard(0) else r for p, q, r in zip(lay["x"], lay["bc"],
                                                       part)]
    y, state = ssd(x.to_local(), dt.to_local(), A.to_local(grad_placements=ag),
                   Bm.to_local(grad_placements=bcg),
                   Cm.to_local(grad_placements=bcg), chunk=chunk)
    B, _, H, P = x.shape
    return (kernels.from_local(y, mesh, lay["x"], x.shape),
            kernels.from_local(state, mesh, lay["state"],
                               (B, H, P, Bm.shape[3])))
